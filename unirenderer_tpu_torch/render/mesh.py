"""Mesh container and host-side geometry processing (counterpart of
`unirenderer_tpu/render/mesh.py`): numpy, as in the reference's
preprocessing stage."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np


@dataclasses.dataclass
class Mesh:
    """Triangle mesh with per-vertex attributes and per-corner indexing.

    v_pos (V, 3); t_pos_idx (T, 3) int32.  Texcoords, normals and tangents
    carry their own index buffers (OBJ style).  Fields hold numpy arrays
    or torch tensors; `render_mesh` takes tensors with a leading batch
    dimension."""
    v_pos: Any
    t_pos_idx: Any
    v_nrm: Optional[Any] = None
    t_nrm_idx: Optional[Any] = None
    v_tex: Optional[Any] = None
    t_tex_idx: Optional[Any] = None
    v_tng: Optional[Any] = None
    t_tng_idx: Optional[Any] = None


def _safe_normalize(x, eps=1e-20):
    return x / np.sqrt(np.maximum((x * x).sum(-1, keepdims=True), eps))


def auto_normals(v_pos: np.ndarray, t_pos_idx: np.ndarray) -> np.ndarray:
    """Area-weighted smooth vertex normals."""
    i0, i1, i2 = t_pos_idx[:, 0], t_pos_idx[:, 1], t_pos_idx[:, 2]
    face_n = np.cross(v_pos[i1] - v_pos[i0], v_pos[i2] - v_pos[i0])
    v_nrm = np.zeros_like(v_pos)
    np.add.at(v_nrm, i0, face_n)
    np.add.at(v_nrm, i1, face_n)
    np.add.at(v_nrm, i2, face_n)
    bad = (v_nrm * v_nrm).sum(-1) < 1e-20
    v_nrm[bad] = np.array([0.0, 0.0, 1.0])
    return _safe_normalize(v_nrm).astype(np.float32)


def compute_tangents(v_pos: np.ndarray, t_pos_idx: np.ndarray,
                     v_tex: np.ndarray, t_tex_idx: np.ndarray,
                     v_nrm: np.ndarray, t_nrm_idx: np.ndarray) -> np.ndarray:
    """Per-vertex tangents from UVs, (Vn, 3), aligned with the normal
    index buffer."""
    vn = v_nrm.shape[0]
    tangents = np.zeros((vn, 3), np.float64)
    tansum = np.zeros((vn, 1), np.float64)

    pos = [v_pos[t_pos_idx[:, i]] for i in range(3)]
    tex = [v_tex[t_tex_idx[:, i]] for i in range(3)]

    uve1 = tex[1] - tex[0]
    uve2 = tex[2] - tex[0]
    pe1 = pos[1] - pos[0]
    pe2 = pos[2] - pos[0]

    nom = pe1 * uve2[:, 1:2] - pe2 * uve1[:, 1:2]
    denom = uve1[:, 0:1] * uve2[:, 1:2] - uve1[:, 1:2] * uve2[:, 0:1]
    sign = np.where(denom > 0, 1.0, -1.0)
    tang = nom / np.maximum(np.abs(denom), 1e-6) * sign

    for i in range(3):
        idx = t_nrm_idx[:, i]
        np.add.at(tangents, idx, tang)
        np.add.at(tansum, idx, 1.0)
    tangents = tangents / np.maximum(tansum, 1.0)
    # Gram-Schmidt against the normal
    tangents = tangents - v_nrm * (tangents * v_nrm).sum(-1, keepdims=True)
    bad = (tangents * tangents).sum(-1) < 1e-16
    # fallback: any vector orthogonal to n
    alt = np.cross(v_nrm, np.array([0.577, 0.577, 0.577]))
    tangents[bad] = alt[bad]
    return _safe_normalize(tangents).astype(np.float32)


def unit_normalize_mesh(v_pos: np.ndarray) -> np.ndarray:
    """Centre and scale to the unit cube."""
    vmin, vmax = v_pos.min(0), v_pos.max(0)
    center = (vmin + vmax) / 2
    scale = 2.0 / max(float((vmax - vmin).max()), 1e-8)
    return ((v_pos - center) * scale).astype(np.float32)


def make_sphere(res: int = 16, radius: float = 1.0) -> Mesh:
    """Analytic UV sphere (numpy arrays): (res + 1) * 2res vertices,
    2res * res * 2 triangles."""
    th = np.linspace(0, np.pi, res + 1)
    ph = np.linspace(0, 2 * np.pi, 2 * res + 1)[:-1]
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    x = np.sin(tt) * np.cos(pp)
    y = np.cos(tt)
    z = np.sin(tt) * np.sin(pp)
    v = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32) * radius
    nphi = 2 * res
    tris = []
    for i in range(res):
        for j in range(nphi):
            a = i * nphi + j
            b = i * nphi + (j + 1) % nphi
            c = (i + 1) * nphi + j
            d = (i + 1) * nphi + (j + 1) % nphi
            tris.append([a, c, b])
            tris.append([b, c, d])
    t = np.asarray(tris, np.int32)
    n = _safe_normalize(v).astype(np.float32)
    uv = np.stack([pp.reshape(-1) / (2 * np.pi),
                   tt.reshape(-1) / np.pi], -1).astype(np.float32)
    tng = compute_tangents(v, t, uv, t, n, t)
    return Mesh(v_pos=v, t_pos_idx=t, v_nrm=n, t_nrm_idx=t, v_tex=uv,
                t_tex_idx=t, v_tng=tng, t_tng_idx=t)
