"""Adafactor as optax computes it (`optax.adafactor(lr,
clipping_threshold=1.0, weight_decay_rate=wd)`, the JAX package's
`optimizer="adafactor"`), written out in PyTorch.

Per parameter, in order: factored second moments with the step-dependent
decay 1 - (t + 1)^-0.8 (`scale_by_factored_rms`), the update clipped to
an RMS of at most `clipping_threshold` (`clip_by_block_rms`), times the
learning rate, times the parameter's RMS floored at 1e-3
(`scale_by_param_block_rms`), plus `weight_decay_rate` x the parameter
(`add_decayed_weights`, after the learning rate: the decay is absolute),
subtracted from the parameter.

optax factors the two largest dimensions of a parameter's *flax* shape,
and not at all when the second largest is under `min_dim_size_to_factor`
or the parameter is 1-D (then it keeps a full second moment `v`).  The
port's conv and linear weights are transposed against flax's, so each
parameter carries the permutation to its flax layout
(`core/convert.flax_permutations`): the factored statistics are reduced
on that view and kept in the flax layout, and the elementwise work runs
as foreach operations over chunks of parameters in their own layout.
"""

from __future__ import annotations

from typing import Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch


def factored_dims(shape: Sequence[int],
                  min_dim_size_to_factor: int = 128
                  ) -> Optional[Tuple[int, int]]:
    """optax `_factored_dims`: (second largest, largest) axes of `shape`
    (numpy's argsort order), or None when not factored."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


# parameters updated together, at most this many elements (a larger one
# alone): the foreach temporaries stay ~1 GiB, not the size of the model
CHUNK_ELEMENTS = 1 << 26


class Adafactor(torch.optim.Optimizer):
    """`params`: an iterable of (tensor, flax permutation or None).  The
    learning rate is the param group's `lr`, set before every step as for
    AdamW."""

    def __init__(self, params: Iterable[Tuple[torch.Tensor,
                                              Optional[Tuple[int, ...]]]],
                 lr: float, weight_decay_rate: Optional[float] = None,
                 clipping_threshold: Optional[float] = 1.0,
                 decay_rate: float = 0.8, eps: float = 1e-30,
                 min_dim_size_to_factor: int = 128,
                 multiply_by_parameter_scale: bool = True):
        groups = {}
        for p, perm in params:
            groups.setdefault(perm, []).append(p)
        defaults = dict(lr=lr, weight_decay_rate=weight_decay_rate,
                        clipping_threshold=clipping_threshold,
                        decay_rate=decay_rate, eps=eps,
                        min_dim_size_to_factor=min_dim_size_to_factor,
                        multiply_by_parameter_scale=(
                            multiply_by_parameter_scale))
        super().__init__([dict(params=ps, flax_perm=perm)
                          for perm, ps in groups.items()], defaults)

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            chunk, size = [], 0
            for p in group["params"]:
                if p.grad is None:
                    continue
                if chunk and size + p.numel() > CHUNK_ELEMENTS:
                    self._update(chunk, group)
                    chunk, size = [], 0
                chunk.append(p)
                size += p.numel()
            if chunk:
                self._update(chunk, group)
        return None

    def _init_state(self, p: torch.Tensor, shape: Tuple[int, ...],
                    dims: Optional[Tuple[int, int]]) -> None:
        state = self.state[p]
        state["step"] = 0
        g = p.grad.new_zeros(())
        if dims is not None:
            d1, d0 = dims
            state["v_row"] = g.new_zeros(np.delete(shape, d0).tolist())
            state["v_col"] = g.new_zeros(np.delete(shape, d1).tolist())
        else:
            state["v"] = g.new_zeros(shape)

    def _update(self, params: Sequence[torch.Tensor],
                group: Mapping) -> None:
        """One update of some of a group's parameters (one flax
        permutation).  The elementwise parts run as foreach operations
        over all of them, each in its own layout; only the factored
        statistics are reduced one parameter at a time, on the flax
        view."""
        perm = group["flax_perm"]
        inv = None if perm is None else tuple(np.argsort(perm))

        def flax(t):
            return t if perm is None else t.permute(perm)

        def torch_layout(t):
            return t if inv is None else t.permute(inv)

        grads = [p.grad for p in params]
        dims = []
        for p in params:
            shape = tuple(flax(p).shape)
            dims.append(factored_dims(shape,
                                      group["min_dim_size_to_factor"]))
            if not self.state[p]:
                self._init_state(p, shape, dims[-1])
        decays, keeps = [], []
        for p in params:
            t = torch.tensor(self.state[p]["step"] + 1, dtype=torch.float32)
            decay_t = 1.0 - t ** (-group["decay_rate"])      # f32, as optax
            decays.append(float(decay_t))
            keeps.append(float(1.0 - decay_t))
        grad_sqr = torch._foreach_mul(grads, grads)
        torch._foreach_add_(grad_sqr, group["eps"])
        updates: List[Optional[torch.Tensor]] = [None] * len(params)
        full = [i for i, d in enumerate(dims) if d is None]
        if full:
            vs = [torch_layout(self.state[params[i]]["v"]) for i in full]
            torch._foreach_mul_(vs, [decays[i] for i in full])
            torch._foreach_add_(vs, torch._foreach_mul(
                [grad_sqr[i] for i in full], [keeps[i] for i in full]))
            for i, u in zip(full, torch._foreach_mul(
                    [grads[i] for i in full], torch._foreach_pow(vs, -0.5))):
                updates[i] = u
        for i, d in enumerate(dims):
            if d is None:
                continue
            d1, d0 = d
            state = self.state[params[i]]
            sq = flax(grad_sqr[i])
            v_row = decays[i] * state["v_row"] + keeps[i] * sq.mean(d0)
            v_col = decays[i] * state["v_col"] + keeps[i] * sq.mean(d1)
            state["v_row"], state["v_col"] = v_row, v_col
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_col_mean = v_row.mean(reduced_d1, keepdim=True)
            row_factor = (v_row / row_col_mean) ** -0.5
            col_factor = v_col ** -0.5
            updates[i] = grads[i] * torch_layout(
                row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1))
        # one scale a parameter: the RMS clip, the learning rate and the
        # parameter's RMS floored at 1e-3
        sizes = torch.tensor([float(p.numel()) for p in params],
                             device=params[0].device).sqrt()
        scale = torch.full_like(sizes, group["lr"])
        if group["clipping_threshold"] is not None:
            rms = torch.stack(torch._foreach_norm(updates)) / sizes
            scale = scale / torch.clamp(rms / group["clipping_threshold"],
                                        min=1.0)
        if group["multiply_by_parameter_scale"]:
            rms = torch.stack(torch._foreach_norm(params)) / sizes
            scale = scale * torch.clamp(rms, min=1e-3)
        torch._foreach_mul_(updates, list(scale.unbind()))
        if group["weight_decay_rate"] is not None:
            torch._foreach_add_(updates, torch._foreach_mul(
                params, group["weight_decay_rate"]))
        torch._foreach_sub_(params, updates)
        for p in params:
            self.state[p]["step"] += 1
