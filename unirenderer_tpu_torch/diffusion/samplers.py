"""DDIM (eta = 0) and UniPC (order <= 2, bh2, data prediction) as pure
step functions, and a loop that drives either over a timestep grid.

Counterpart of `unirenderer_tpu/diffusion/samplers.py` (`ddim_step`,
`UniPCState`, `_uni_bh2_update`, `unipc_step`, `sample_loop`, its
`lax.scan` a Python loop), kept line for line, including the
step-0 history sanitisation: at step 0 the corrector sees (x, x0_pred, t),
so h == 0 and its update is exactly the identity whichever branch of the
`where` is taken, and at step <= 1 the second history point falls back to
the first.  All math is f32 and stays on the latents' device (no host
synchronisation per step).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from unirenderer_tpu_torch.diffusion.schedule import DiffusionSchedule


def ddim_step(schedule: DiffusionSchedule, x: torch.Tensor,
              x0_pred: torch.Tensor, t: torch.Tensor,
              t_next: torch.Tensor) -> torch.Tensor:
    """Deterministic DDIM update from timestep t to t_next (x0
    prediction): eps = (x - a_t x0) / s_t, x' = a_n x0 + s_n eps; a
    negative t_next means the clean end (a_n = 1, s_n = 0)."""
    a_t, s_t = schedule.alpha_sigma(t)
    a_n, s_n = schedule.alpha_sigma(torch.clamp(t_next, min=0))
    last = t_next < 0
    a_n = torch.where(last, torch.ones_like(a_n), a_n)
    s_n = torch.where(last, torch.zeros_like(s_n), s_n)
    eps = (x - a_t * x0_pred) / s_t
    return a_n * x0_pred + s_n * eps


@dataclasses.dataclass
class UniPCState:
    """Multistep history for one latent group: m0/m1 the two newest model
    (x0) outputs, t0/t1 their timesteps, last_sample the corrector input,
    step the loop index (all tensors)."""
    m0: torch.Tensor
    m1: torch.Tensor
    t0: torch.Tensor
    t1: torch.Tensor
    last_sample: torch.Tensor
    step: torch.Tensor

    @classmethod
    def init(cls, shape, device="cpu") -> "UniPCState":
        z = torch.zeros(shape, dtype=torch.float32, device=device)
        zi = torch.zeros((), dtype=torch.long, device=device)
        return cls(m0=z, m1=z, t0=zi, t1=zi, last_sample=z, step=zi)


def _alpha_sigma_lambda(schedule: DiffusionSchedule, t: torch.Tensor):
    a, s = schedule.alpha_sigma(torch.clamp(t, min=0))
    lam = torch.log(a) - torch.log(torch.clamp(s, min=1e-10))
    return a, s, lam


def _uni_bh2_update(schedule: DiffusionSchedule, x: torch.Tensor,
                    m0: torch.Tensor, s0: torch.Tensor, t: torch.Tensor,
                    m1: torch.Tensor, s1: torch.Tensor,
                    use_second: torch.Tensor,
                    corrector_mt: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Shared core of the UniP (predictor) and UniC (corrector) bh2 update
    from timestep s0 to t (see the JAX function for the derivation)."""
    _, sig_s0, lam_s0 = _alpha_sigma_lambda(schedule, s0)
    alp_t, sig_t, lam_t = _alpha_sigma_lambda(schedule, t)
    _, _, lam_s1 = _alpha_sigma_lambda(schedule, s1)
    one = torch.ones((), dtype=lam_t.dtype, device=lam_t.device)

    h = lam_t - lam_s0
    hh = -h
    phi1 = torch.expm1(hh)
    b_h = phi1                                   # bh2: B(h) = expm1(hh)
    # h == 0 by construction at step 0; every division is guarded so no
    # inf/NaN can poison the update there
    safe_hh = torch.where(hh == 0, one, hh)
    safe_bh = torch.where(b_h == 0, one, b_h)

    r1 = (lam_s1 - lam_s0) / torch.where(h == 0, one, h)
    safe_r1 = torch.where(torch.abs(r1) < 1e-8, one, r1)
    d1 = (m1 - m0) / safe_r1
    d1 = torch.where(use_second, d1, torch.zeros_like(d1))

    x_t_ = sig_t / sig_s0 * x - alp_t * phi1 * m0

    if corrector_mt is None:
        res = 0.5 * d1                           # predictor, rho_p = 0.5
        return x_t_ - alp_t * b_h * res
    h_phi_k1 = phi1 / safe_hh - 1.0
    h_phi_k2 = h_phi_k1 / safe_hh - 0.5
    b1 = h_phi_k1 / safe_bh
    b2 = h_phi_k2 * 2.0 / safe_bh
    det = torch.where(torch.abs(1.0 - safe_r1) < 1e-8, one, 1.0 - safe_r1)
    rho_hist2 = (b1 - b2) / det
    rho_new2 = (b2 - safe_r1 * b1) / det
    rho_hist = torch.where(use_second, rho_hist2, torch.zeros_like(rho_hist2))
    rho_new = torch.where(use_second, rho_new2, torch.full_like(rho_new2, 0.5))
    d1_t = corrector_mt - m0
    res = rho_hist * d1 + rho_new * d1_t
    return x_t_ - alp_t * b_h * res


def unipc_step(schedule: DiffusionSchedule, state: UniPCState,
               x: torch.Tensor, x0_pred: torch.Tensor, t: torch.Tensor,
               t_next: torch.Tensor, is_final: torch.Tensor
               ) -> Tuple[UniPCState, torch.Tensor]:
    """One UniPC step: corrector on the previous transition, then the
    predictor for t -> t_next.  `x0_pred` is the model output at (x, t);
    t, t_next (long) and is_final (bool) are 0-dim tensors."""
    step = state.step

    # sanitise the history so step-0/1 garbage can never leak
    first = step == 0
    last_sample = torch.where(first, x, state.last_sample)
    m0 = torch.where(first, x0_pred, state.m0)
    t0 = torch.where(first, t, state.t0)
    m1 = torch.where(step <= 1, m0, state.m1)
    t1 = torch.where(step <= 1, t0, state.t1)

    # corrector (identity at step 0 by construction)
    corr_second = step >= 2
    x_corr = _uni_bh2_update(schedule, last_sample, m0, t0, t, m1, t1,
                             corr_second, corrector_mt=x0_pred)
    x = torch.where(step > 0, x_corr, x)

    # predictor t -> t_next
    pred_second = (step >= 1) & torch.logical_not(is_final)
    x_next = _uni_bh2_update(schedule, x, x0_pred, t, t_next, m0, t0,
                             pred_second, corrector_mt=None)

    new_state = UniPCState(m0=x0_pred, m1=m0, t0=t, t1=t0, last_sample=x,
                           step=step + 1)
    return new_state, x_next


def sample_loop(schedule: DiffusionSchedule,
                model_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                x_init: torch.Tensor, timesteps: torch.Tensor,
                method: str = "unipc") -> torch.Tensor:
    """Denoise x_init over `timesteps` (descending, long) with
    model_fn(x, t) -> x0, by "ddim" or "unipc"."""
    if method not in ("ddim", "unipc"):
        raise ValueError(f"method {method!r}: 'ddim' or 'unipc'")
    n = timesteps.shape[0]
    ts_next = torch.cat([timesteps[1:], timesteps.new_zeros(1)])
    x = x_init
    if method == "ddim":
        for i in range(n):
            x = ddim_step(schedule, x, model_fn(x, timesteps[i]),
                          timesteps[i], ts_next[i])
        return x
    state = UniPCState.init(x.shape, device=x.device)
    is_final = torch.arange(n, device=x.device) == n - 1
    for i in range(n):
        state, x = unipc_step(schedule, state, x, model_fn(x, timesteps[i]),
                              timesteps[i], ts_next[i], is_final[i])
    return x
