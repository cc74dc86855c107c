"""The port's `core/tracing.profile_trace` and `core/debug.checkify_finite`
(counterparts of the JAX package's), on the CPU:

  * `profile_trace(log_dir)` writes a Chrome trace of its body under
    `log_dir` and records nothing for None or "";
  * `checkify_finite(fn)` returns fn's result unchanged on finite inputs,
    and raises FloatingPointError naming the operation that made a NaN or
    an Inf inside fn, also where a later operation hides it from the
    output (`nan_to_num(log(x))` on a negative entry), as JAX's
    `checkify_finite` (`float_checks`) does on the same function.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import use_one_thread
from unirenderer_tpu.core.debug import checkify_finite as jax_checkify_finite
from unirenderer_tpu_torch.core.debug import checkify_finite
from unirenderer_tpu_torch.core.tracing import profile_trace

use_one_thread()


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with profile_trace(str(log_dir)) as prof:
        assert prof is not None
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(log_dir / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


@pytest.mark.parametrize("log_dir", [None, ""])
def test_profile_trace_without_a_directory_records_nothing(
        log_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with profile_trace(log_dir) as prof:
        out = torch.ones(3).sum()
    assert prof is None and float(out) == 3.0
    assert os.listdir(tmp_path) == []


def _hidden_nan(x):
    """log of a negative entry is NaN; nan_to_num hides it from the
    output."""
    return {"y": torch.nan_to_num(x.log()), "n": x.shape[0]}


def test_checkify_finite_returns_the_result_unchanged():
    x = torch.tensor([0.5, 1.0, 2.0, 4.0])
    got = checkify_finite(_hidden_nan)(x)
    want = _hidden_nan(x)
    assert got.keys() == want.keys() and got["n"] == want["n"]
    assert torch.equal(got["y"], want["y"])
    kw = checkify_finite(lambda a, scale=1.0: a * scale)(x, scale=3.0)
    assert torch.equal(kw, x * 3.0)


def test_checkify_finite_names_the_op_that_made_a_hidden_nan():
    x = np.array([0.5, -1.0, 2.0], np.float32)
    assert torch.isfinite(_hidden_nan(torch.from_numpy(x))["y"]).all()
    with pytest.raises(FloatingPointError, match=r"aten\.log.*NaN"):
        checkify_finite(_hidden_nan)(torch.from_numpy(x))
    # JAX's checkify raises on the same function and input, and not on a
    # finite one
    jfn = jax_checkify_finite(lambda a: jnp.nan_to_num(jnp.log(a)))
    jfn(jnp.asarray(np.abs(x)))
    with pytest.raises(Exception, match="nan"):
        jfn(jnp.asarray(x))


def test_checkify_finite_names_the_op_that_made_an_inf():
    x = torch.tensor([1.0, 0.0, 2.0])
    with pytest.raises(FloatingPointError, match=r"aten\.reciprocal.*Inf"):
        checkify_finite(lambda a: torch.clamp(a.reciprocal(), max=1.0))(x)
