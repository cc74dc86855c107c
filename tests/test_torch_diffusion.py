"""Parity of the port's DDPM schedule and UniPC step with the JAX package,
including ports of the two step-0 regression cases of
tests/test_samplers.py (the sanitised history must make step 0 immune to
whatever the state holds).

Tolerances: the schedule and one step agree to 1e-6 relative (f32 on both
sides, same formulas; only `linspace`/`cumprod` rounding may differ); a
whole trajectory to 1e-5 relative (20 steps of the same f32 arithmetic).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unirenderer_tpu.core.config import DiffusionConfig as JDiffusionConfig
from unirenderer_tpu.diffusion import samplers as jsamplers
from unirenderer_tpu.diffusion.schedule import (
    DiffusionSchedule as JSchedule, inference_timesteps as j_timesteps,
)
from unirenderer_tpu_torch.core.config import DiffusionConfig
from unirenderer_tpu_torch.diffusion import samplers as tsamplers
from unirenderer_tpu_torch.diffusion.schedule import (
    DiffusionSchedule, inference_timesteps,
)
from tests.torch_port_helpers import assert_rel_close

JSCH = JSchedule.create(JDiffusionConfig())
TSCH = DiffusionSchedule.create(DiffusionConfig())

from torch_port_helpers import use_one_thread  # noqa: E402

use_one_thread()


def test_schedule_matches_jax():
    assert_rel_close(TSCH.alphas_cumprod, np.asarray(JSCH.alphas_cumprod),
                     1e-6, "alphas_cumprod")
    t = np.array([0, 1, 250, 999])
    for got, want in zip(TSCH.alpha_sigma(torch.from_numpy(t)),
                         JSCH.alpha_sigma(jnp.asarray(t))):
        assert_rel_close(got, np.asarray(want), 1e-6, "alpha_sigma")


@pytest.mark.parametrize("n", [3, 8, 20, 50])
def test_inference_timesteps_match_jax(n):
    np.testing.assert_array_equal(inference_timesteps(1000, n),
                                  np.asarray(j_timesteps(1000, n)))


def _run(n_steps, model_np, x0):
    """Drive both unipc_step implementations over the same grid with the
    same x-dependent model; returns both final latents."""
    ts = inference_timesteps(1000, n_steps)
    ts_next = np.concatenate([ts[1:], [0]])
    jst = jsamplers.UniPCState.init(x0.shape, jnp.float32)
    tst = tsamplers.UniPCState.init(x0.shape)
    jx, tx = jnp.asarray(x0), torch.from_numpy(x0)
    for i, (t, tn) in enumerate(zip(ts, ts_next)):
        fin = i == n_steps - 1
        jst, jx = jsamplers.unipc_step(
            JSCH, jst, jx, jnp.asarray(model_np(np.asarray(jx), t)),
            jnp.int32(t), jnp.int32(tn), fin)
        tst, tx = tsamplers.unipc_step(
            TSCH, tst, tx, torch.from_numpy(model_np(tx.numpy(), t)),
            torch.tensor(int(t)), torch.tensor(int(tn)), torch.tensor(fin))
    return tx, np.asarray(jx)


@pytest.mark.parametrize("n_steps", [3, 20])
def test_unipc_trajectory_matches_jax(n_steps):
    x0 = np.random.default_rng(n_steps).standard_normal(
        (2, 4, 4, 4)).astype(np.float32)

    def model(x, t):
        return (0.3 + 0.2 * np.tanh(x) * (1.0 + t / 1000.0)).astype(np.float32)

    got, want = _run(n_steps, model, x0)
    assert_rel_close(got, want, 1e-5, f"unipc {n_steps} steps")


def test_unipc_step0_garbage_history_cannot_leak():
    """Port of the JAX regression: NaN history at step 0 must give the
    bit-identical, finite output and carried state of a clean run."""
    shape = (2, 4, 4, 4)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    x0p = torch.from_numpy(0.3 * rng.standard_normal(shape).astype(np.float32))
    clean = tsamplers.UniPCState.init(shape)
    bad = torch.full(shape, float("nan"))
    zi = torch.zeros((), dtype=torch.long)
    poisoned = tsamplers.UniPCState(m0=bad, m1=bad, t0=zi, t1=zi,
                                    last_sample=bad, step=zi)
    args = (x, x0p, torch.tensor(999), torch.tensor(949), torch.tensor(False))
    st_c, x_c = tsamplers.unipc_step(TSCH, clean, *args)
    st_p, x_p = tsamplers.unipc_step(TSCH, poisoned, *args)
    assert torch.isfinite(x_c).all()
    assert torch.equal(x_c, x_p)
    for f in ("m0", "m1", "t0", "t1", "last_sample", "step"):
        assert torch.equal(getattr(st_c, f), getattr(st_p, f)), f
    # and the step itself equals the JAX step
    _, jx = jsamplers.unipc_step(
        JSCH, jsamplers.UniPCState.init(shape, jnp.float32), jnp.asarray(x),
        jnp.asarray(x0p), 999, 949, False)
    assert_rel_close(x_c, np.asarray(jx), 1e-6, "step 0")


def test_unipc_corrector_identity_at_step0_under_forced_apply():
    """Port of the JAX regression: with history (x, x0p, t) the corrector
    is the exact identity even when applied unconditionally."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((1, 4, 4, 4)).astype(np.float32))
    x0p = torch.from_numpy(
        0.5 * rng.standard_normal((1, 4, 4, 4)).astype(np.float32))
    t = torch.tensor(999)
    out = tsamplers._uni_bh2_update(TSCH, x, x0p, t, t, x0p, t,
                                    torch.tensor(False), corrector_mt=x0p)
    assert torch.isfinite(out).all()
    assert torch.equal(out, x)
