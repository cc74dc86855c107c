"""PBR BSDF primitives (counterpart of `unirenderer_tpu/ops/bsdf.py`):
the shading normal the split-sum renderer bends, and the point-light BSDF
evaluation (Lambert and Frostbite diffuse, the GGX specular chain,
`pbr_bsdf`).  Elementwise torch over (..., 3) tensors; autograd gives the
backward, as `jax.grad` does in JAX."""

from __future__ import annotations

import math

import torch

NORMAL_THRESHOLD = 0.1
SPECULAR_EPSILON = 1e-4


def dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * y, dim=-1, keepdim=True)


def reflect(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    return 2.0 * dot(x, n) * n - x


def safe_normalize(x: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return x * torch.rsqrt(torch.clamp(torch.sum(x * x, -1, keepdim=True),
                                       min=eps))


def length(x: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return torch.sqrt(torch.clamp(torch.sum(x * x, -1, keepdim=True),
                                  min=eps))


def _bend_normal(view_vec, smooth_nrm, geom_nrm, two_sided_shading: bool):
    if two_sided_shading:
        flip = dot(geom_nrm, view_vec) > 0
        smooth_nrm = torch.where(flip, smooth_nrm, -smooth_nrm)
        geom_nrm = torch.where(flip, geom_nrm, -geom_nrm)
    t = torch.clamp(dot(view_vec, smooth_nrm) / NORMAL_THRESHOLD, 0.0, 1.0)
    return geom_nrm + t * (smooth_nrm - geom_nrm)


def _perturb_normal(perturbed_nrm, smooth_nrm, smooth_tng, opengl: bool):
    smooth_bitang = safe_normalize(torch.cross(smooth_tng, smooth_nrm,
                                               dim=-1))
    sign = -1.0 if opengl else 1.0
    shading_nrm = (smooth_tng * perturbed_nrm[..., 0:1]
                   + sign * smooth_bitang * perturbed_nrm[..., 1:2]
                   + smooth_nrm * torch.clamp(perturbed_nrm[..., 2:3],
                                              min=0.0))
    return safe_normalize(shading_nrm)


def prepare_shading_normal(pos, view_pos, perturbed_nrm, smooth_nrm,
                           smooth_tng, geom_nrm, two_sided_shading=True,
                           opengl=True) -> torch.Tensor:
    """Bent shading normal.  `perturbed_nrm` may be None."""
    smooth_nrm = safe_normalize(smooth_nrm)
    view_vec = safe_normalize(view_pos - pos)
    if perturbed_nrm is None:
        shading_nrm = smooth_nrm
    else:
        smooth_tng = safe_normalize(smooth_tng)
        shading_nrm = _perturb_normal(perturbed_nrm, smooth_nrm, smooth_tng,
                                      opengl)
    return _bend_normal(view_vec, shading_nrm, geom_nrm, two_sided_shading)


# ---------------------------------------------------------------------------
# Diffuse BSDFs
# ---------------------------------------------------------------------------

def lambert(nrm, wi) -> torch.Tensor:
    return torch.clamp(dot(nrm, wi), min=0.0) / math.pi


def frostbite_diffuse(nrm, wi, wo, linear_roughness) -> torch.Tensor:
    wi_dot_n = dot(wi, nrm)
    wo_dot_n = dot(wo, nrm)
    h = safe_normalize(wo + wi)
    wi_dot_h = dot(wi, h)
    energy_bias = 0.5 * linear_roughness
    energy_factor = 1.0 - (0.51 / 1.51) * linear_roughness
    f90 = energy_bias + 2.0 * wi_dot_h * wi_dot_h * linear_roughness
    wi_scatter = fresnel_schlick(1.0, f90, wi_dot_n)
    wo_scatter = fresnel_schlick(1.0, f90, wo_dot_n)
    res = wi_scatter * wo_scatter * energy_factor
    return torch.where((wi_dot_n > 0.0) & (wo_dot_n > 0.0), res,
                       torch.zeros_like(res))


# ---------------------------------------------------------------------------
# The GGX specular chain
# ---------------------------------------------------------------------------

def _clip_cos(cos_theta):
    return torch.clamp(cos_theta, SPECULAR_EPSILON, 1.0 - SPECULAR_EPSILON)


def fresnel_schlick(f0, f90, cos_theta) -> torch.Tensor:
    return f0 + (f90 - f0) * (1.0 - _clip_cos(cos_theta)) ** 5.0


def ndf_ggx(alpha_sqr, cos_theta) -> torch.Tensor:
    c = _clip_cos(cos_theta)
    d = (c * alpha_sqr - c) * c + 1.0
    return alpha_sqr / (d * d * math.pi)


def lambda_ggx(alpha_sqr, cos_theta) -> torch.Tensor:
    c = _clip_cos(cos_theta)
    c_sqr = c * c
    tan_sqr = (1.0 - c_sqr) / c_sqr
    return 0.5 * (torch.sqrt(1.0 + alpha_sqr * tan_sqr) - 1.0)


def masking_smith_ggx_correlated(alpha_sqr, cos_theta_i, cos_theta_o):
    li = lambda_ggx(alpha_sqr, cos_theta_i)
    lo = lambda_ggx(alpha_sqr, cos_theta_o)
    return 1.0 / (1.0 + li + lo)


def pbr_specular(col, nrm, wo, wi, alpha, min_roughness=0.08
                 ) -> torch.Tensor:
    _alpha = torch.clamp(alpha, min_roughness * min_roughness, 1.0)
    alpha_sqr = _alpha * _alpha
    h = safe_normalize(wo + wi)
    wo_dot_n = dot(wo, nrm)
    wi_dot_n = dot(wi, nrm)
    wo_dot_h = dot(wo, h)
    n_dot_h = dot(nrm, h)
    d = ndf_ggx(alpha_sqr, n_dot_h)
    g = masking_smith_ggx_correlated(alpha_sqr, wo_dot_n, wi_dot_n)
    f = fresnel_schlick(col, 1.0, wo_dot_h)
    w = f * d * g * 0.25 / torch.clamp(wo_dot_n, min=SPECULAR_EPSILON)
    frontfacing = ((wo_dot_n > SPECULAR_EPSILON)
                   & (wi_dot_n > SPECULAR_EPSILON))
    return torch.where(frontfacing, w, torch.zeros_like(w))


def pbr_bsdf(kd, arm, pos, nrm, view_pos, light_pos, min_roughness=0.08,
             diffuse_bsdf: str = "lambert") -> torch.Tensor:
    """Point-light PBR BSDF.  kd: (..., 3) albedo; arm: (..., 3) [ao,
    roughness, metallic]; `diffuse_bsdf` "lambert" or "frostbite"."""
    wo = safe_normalize(view_pos - pos)
    wi = safe_normalize(light_pos - pos)
    spec_str = arm[..., 0:1]
    roughness = arm[..., 1:2]
    metallic = arm[..., 2:3]
    ks = (0.04 * (1.0 - metallic) + kd * metallic) * (1.0 - spec_str)
    kd_ = kd * (1.0 - metallic)
    if diffuse_bsdf == "frostbite":
        diffuse = kd_ * frostbite_diffuse(nrm, wi, wo, roughness)
    else:
        diffuse = kd_ * lambert(nrm, wi)
    specular = pbr_specular(ks, nrm, wo, wi, roughness * roughness,
                            min_roughness=min_roughness)
    return diffuse + specular
