"""Checkpoints of the port: the JAX package's params-only `.npz` format
(numpy only), and full-state checkpoints with rotation and resume.

Counterparts of `unirenderer_tpu/core/checkpoint.py`: `load_params_npz` /
`save_params_npz` take and return the flax paths joined with `/` (the
file's keys, which `core/convert.py` maps); `CheckpointManager` and
`AsyncSaver` keep its layout and semantics without orbax.  A step
directory `<dir>/checkpoint-<step>` holds

    params.npz   the module's params in the JAX format, f32 (the JAX
                 package's `load_params_npz` reads it);
    state.pt     `torch.save` of the rest of the training state: the
                 optimizer's state dict, the step counters, the gradient
                 accumulator and the host generator's state.

A save is written into a hidden temporary directory and renamed into
place, so a killed save never leaves a `checkpoint-<step>` that reads as
complete; `restore_params` tries steps newest-first and falls back past
one that cannot be read.
"""

from __future__ import annotations

import os
import re
import shutil
import threading
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

PARAMS_FILE = "params.npz"
STATE_FILE = "state.pt"


def load_params_npz(path: str) -> Tuple[Dict[str, np.ndarray], Optional[int]]:
    """-> ({flax path: array, float leaves as f32}, step or None)."""
    flat: Dict[str, np.ndarray] = {}
    step = None
    with np.load(path) as z:
        for key in z.files:
            if key == "__step__":
                s = int(z[key])
                step = None if s < 0 else s
                continue
            arr = z[key]
            flat[key] = arr.astype(np.float32) if arr.dtype.kind == "f" else arr
    return flat, step


def save_params_npz(path: str, flat: Dict[str, np.ndarray],
                    step: Optional[int] = None,
                    dtype: Optional[str] = None) -> None:
    """Write {flax path: array} as one npz in the JAX format, the step
    under `__step__` (-1 for none), so the JAX package's `load_params_npz`
    reads it.  `dtype` None: every leaf in its own type, uncompressed (a
    checkpoint's f32 masters restore bit-equal); else as the JAX writer
    exports (its `save_params_npz(..., dtype)`): compressed, float leaves
    cast to `dtype` ("float16" or "float32"), the others as they are."""
    out = {k: np.asarray(a) for k, a in flat.items()}
    step_arr = np.int64(-1 if step is None else step)
    if dtype is None:
        np.savez(path, __step__=step_arr, **out)
        return
    out = {k: a.astype(dtype) if a.dtype.kind == "f" else a
           for k, a in out.items()}
    np.savez_compressed(path, __step__=step_arr, **out)


def map_tensors(fn: Callable[[torch.Tensor], Any], obj):
    """`obj` (nested dicts, lists, tuples) with `fn` applied to every
    tensor in it."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: map_tensors(fn, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(map_tensors(fn, v) for v in obj)
    return obj


class CheckpointManager:
    """`<directory>/checkpoint-<step>` directories, the newest
    `total_limit` kept."""

    def __init__(self, directory: str, total_limit: int = 5):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.total_limit = total_limit
        self._restored_step: Optional[int] = None

    # -- paths ----------------------------------------------------------
    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"checkpoint-{step}")

    def all_steps(self) -> List[int]:
        steps = []
        for d in os.listdir(self.directory):
            m = re.fullmatch(r"checkpoint-(\d+)", d)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restored_step(self) -> Optional[int]:
        """Step of the checkpoint the last restore actually read (older
        than `latest_step()` after a fallback)."""
        return (self._restored_step if self._restored_step is not None
                else self.latest_step())

    # -- save / restore -------------------------------------------------
    def save(self, step: int, params: Mapping[str, np.ndarray],
             state: Mapping[str, Any]) -> str:
        """Write one step: `params` ({flax path: array}, kept in f32) and
        `state` (host tensors and Python values).  Returns its directory."""
        final = self.step_dir(step)
        tmp = os.path.join(self.directory, f".tmp-checkpoint-{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        save_params_npz(os.path.join(tmp, PARAMS_FILE), dict(params), step)
        torch.save(dict(state), os.path.join(tmp, STATE_FILE))
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        self._rotate()
        return final

    def _first_readable(self, step: Optional[int],
                        load: Callable[[str], Any]) -> Any:
        """`load(step directory)` of `step`, or with `step` None of the
        newest step it can read (a killed or corrupt save is passed over);
        None if there is none."""
        steps = [step] if step is not None else self.all_steps()[::-1]
        for s in steps:
            try:
                out = load(self.step_dir(s))
            except Exception as e:          # unfinished / corrupt dir
                if step is not None:
                    raise
                print(f"[checkpoint] step {s} unreadable ({e!r}); "
                      f"trying older", flush=True)
                continue
            self._restored_step = s
            return out
        return None

    def restore(self, step: Optional[int] = None
                ) -> Optional[Tuple[Dict[str, np.ndarray], Dict[str, Any]]]:
        """(params, state) of `step`, default the newest readable one;
        None if there is no checkpoint."""
        return self._first_readable(step, lambda d: (
            load_params_npz(os.path.join(d, PARAMS_FILE))[0],
            torch.load(os.path.join(d, STATE_FILE), map_location="cpu",
                       weights_only=True)))

    def restore_params(self, step: Optional[int] = None
                       ) -> Optional[Dict[str, np.ndarray]]:
        """Just the params ({flax path: array}) of `step`, default the
        newest readable one: the inference loaders' path.
        `restored_step()` then names the step read."""
        return self._first_readable(step, lambda d: load_params_npz(
            os.path.join(d, PARAMS_FILE))[0])

    def _rotate(self) -> None:
        steps = self.all_steps()
        while len(steps) > self.total_limit:
            shutil.rmtree(self.step_dir(steps.pop(0)), ignore_errors=True)


class AsyncSaver:
    """Checkpoint a step loop without stalling it on the device-to-host
    copy: `save` snapshots the tensors on the device (`clone`), then
    copies them to the host and writes them in a background thread; at
    most one save is in flight (a new save joins the previous first).
    An error of the writer is raised by the next `join`."""

    def __init__(self, ckpt: CheckpointManager):
        self.ckpt = ckpt
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    @staticmethod
    def snapshot(params: Mapping[str, torch.Tensor],
                 state: Mapping[str, Any]):
        """Device copies of the params and of every tensor in `state`."""
        with torch.no_grad():
            return ({n: t.detach().clone() for n, t in params.items()},
                    map_tensors(lambda t: t.detach().clone(), dict(state)))

    def save(self, step: int, module: torch.nn.Module,
             params: Mapping[str, torch.Tensor], state: Mapping[str, Any],
             blocking: bool = False) -> None:
        """Save `params` (by `module`'s parameter names; written in the
        flax layout of `module`) and `state` as checkpoint `step`."""
        from unirenderer_tpu_torch.core.convert import flax_from_module
        self.join()
        snap_params, snap_state = self.snapshot(params, state)

        def fetch_and_write():
            try:
                flat = flax_from_module(module, snap_params)
                host = map_tensors(lambda t: t.cpu(), snap_state)
                self.ckpt.save(step, flat, host)
            except BaseException as e:      # surfaced by join()
                self._error = e

        if blocking:
            fetch_and_write()
            self._raise()
        else:
            self._thread = threading.Thread(target=fetch_and_write,
                                            daemon=True)
            self._thread.start()

    def join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise()

    def _raise(self) -> None:
        if self._error is not None:
            e, self._error = self._error, None
            raise e
