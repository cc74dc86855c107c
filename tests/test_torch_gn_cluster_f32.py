"""K1 f32's cluster kernel (csrc/groupnorm_f32.cu) as far as the CPU can
hold it: the plain mirror of its statistics (`cluster_stats_reference`:
its row ranges and its merge of the ranks in rank order) against the JAX
kernel in interpret mode and against f64 two-pass statistics, and the
wrapper's route to each kernel, with the libraries replaced by stand-ins
that stop at the call.  The kernel itself runs on the card
(tests/test_torch_card.py, chip_smoke.py phase 15 (a)).

Tolerances: 2^-16 * max|ref|, the card's f32 K1 gate: the JAX kernel
sums x and x^2 in one pass where the mirror merges per-rank two-pass
statistics, both in f32.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import assert_rel_close
from unirenderer_tpu.ops.groupnorm import _fused_fwd
from unirenderer_tpu_torch.ops import groupnorm as gn

from torch_port_helpers import use_one_thread  # noqa: E402

use_one_thread()

REL = 2.0 ** -16


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.standard_normal(shape) * 2.0 + 0.5).astype(np.float32)
    sc = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bi = rng.uniform(-0.2, 0.2, c).astype(np.float32)
    return x, sc, bi


def _apply(x, sc, bi, groups, eps, silu, mean, var):
    """y from given statistics, as the kernel applies them."""
    b, c = x.shape[0], x.shape[-1]
    xg = x.reshape(b, -1, groups, c // groups)
    y = (xg - mean[:, None, :, None]) * torch.rsqrt(var + eps)[:, None, :,
                                                              None]
    y = y.reshape(x.shape) * sc + bi
    return y * torch.sigmoid(y) if silu else y


@pytest.mark.parametrize("shape,groups,ctas,eps,silu", [
    ((2, 64, 64, 32), 8, 8, 1e-6, True),    # small()'s VAE: 512 rows a rank
    ((1, 37, 29, 36), 4, 8, 1e-6, False),   # ragged: 7 x 135 rows and 128
    ((2, 16, 16, 128), 16, 1, 1e-5, True),  # small()'s UNet, cluster of 1
    ((1, 3, 3, 8), 2, 8, 1e-5, True),       # 9 rows: ranks 5-7 hold none
])
def test_cluster_stats_match_jax_kernel_and_f64(shape, groups, ctas, eps,
                                                silu):
    x, sc, bi = _inputs(shape, ctas)
    xt = torch.from_numpy(x)
    mean, var = gn.cluster_stats_reference(xt, groups, ctas)
    assert mean.dtype == var.dtype == torch.float32
    assert mean.shape == var.shape == (shape[0], groups)
    xd = xt.double().reshape(shape[0], -1, groups, shape[-1] // groups)
    mean64 = xd.mean(dim=(1, 3))
    var64 = ((xd - mean64[:, None, :, None]) ** 2).mean(dim=(1, 3))
    assert_rel_close(mean.numpy(), mean64.numpy(), REL, "mean vs f64")
    assert_rel_close(var.numpy(), var64.numpy(), REL, "variance vs f64")
    want = _fused_fwd(jnp.asarray(x), jnp.asarray(sc), jnp.asarray(bi),
                      groups, eps, silu, interpret=True)
    got = _apply(xt, torch.from_numpy(sc), torch.from_numpy(bi), groups, eps,
                 silu, mean, var)
    assert_rel_close(got.numpy(), np.asarray(want), REL,
                     "y from the cluster statistics vs the JAX kernel")


class _Stop(Exception):
    pass


class _Library:
    """A stand-in for a kernel library: every entry point stops at the
    call, naming itself."""

    def __getattr__(self, name):
        def entry(*args):
            raise _Stop(name)
        return entry


@pytest.fixture
def stand_ins(monkeypatch):
    """Both libraries replaced, the stream and the workspace size given:
    returns the (shape, ...) keys the cluster plan was asked about and a
    setter for the CTAs it answers."""
    asked, answer = [], {"ctas": 0}

    def cluster_plan(*key):
        asked.append(key)
        return dict(answer, rows_per_block=1, threads=32, smem_bytes=0)

    monkeypatch.setattr(gn, "_lib", _Library)
    monkeypatch.setattr(gn, "_lib_f32", _Library)
    monkeypatch.setattr(gn, "_cluster_plan", cluster_plan)
    monkeypatch.setattr(gn, "_max_blocks", lambda index: 1)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    return asked, lambda ctas: answer.update(ctas=ctas)


@pytest.mark.parametrize("dtype,ctas,entry", [
    (torch.float32, 8, "gn_cluster_forward_f32"),  # the plan takes it
    (torch.float32, 1, "gn_cluster_forward_f32"),
    (torch.float32, 0, "gn_silu_forward_f32"),     # it does not
    (torch.bfloat16, 8, "gn_silu_forward"),        # bf16: never asked
])
def test_launch_goes_to_the_kernel_the_shape_decides(stand_ins, dtype, ctas,
                                                     entry):
    asked, set_ctas = stand_ins
    set_ctas(ctas)
    x = torch.zeros((2, 4, 4, 32), dtype=dtype)
    w = torch.ones(32)
    with pytest.raises(_Stop) as stop:
        gn._launch(x, w, w, 8, 1e-5, True)
    assert str(stop.value) == entry
    if dtype == torch.float32:
        assert asked == [(2, 16, 32, 8, gn._PARAM_TYPES[torch.float32],
                          None)]
    else:
        assert asked == []


def test_launch_still_refuses_f16(stand_ins):
    asked, _ = stand_ins
    x = torch.zeros((1, 4, 4, 32), dtype=torch.float16)
    w = torch.ones(32)
    with pytest.raises(TypeError):
        gn._launch(x, w, w, 8, 1e-5, True)
    assert asked == []


@pytest.mark.parametrize("ctas,cached,branch", [
    (4, 0, "cluster"), (0, 1, "cached"), (0, 0, "re-read"),
])
def test_plan_names_its_branch(stand_ins, monkeypatch, ctas, cached, branch):
    _, set_ctas = stand_ins
    set_ctas(ctas)

    class Cooperative:
        @staticmethod
        def gn_plan(*args):
            out = ctypes.cast(args[-1], ctypes.POINTER(ctypes.c_int))
            for i, v in enumerate((cached, 264, 16, 1024, 65536)):
                out[i] = v
            return 0

    monkeypatch.setattr(gn, "_lib", Cooperative)
    monkeypatch.setattr(torch.cuda, "device", lambda device: _NoDevice())
    got = gn.plan((2, 16, 16, 128), 16, torch.float32, torch.float32)
    assert got["branch"] == branch
    assert got["cached"] == (branch != "re-read")
    assert got["blocks"] == (2 * ctas if ctas else 264)


class _NoDevice:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
