"""Camera math (counterpart of `unirenderer_tpu/render/camera.py`):
OpenGL-style perspective, look-at, and the spherical pose sampler, in
float32 on the CPU.  Matrices are (4, 4) row-major, applied to row
vectors as p @ M^T."""

from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def perspective(fovy_rad: float, aspect: float = 1.0, near: float = 0.1,
                far: float = 1000.0) -> torch.Tensor:
    """Projection with y negated, so world +y lands at the image top of
    the y-down raster."""
    y = math.tan(fovy_rad / 2)
    return _f32([
        [1.0 / (y * aspect), 0, 0, 0],
        [0, 1.0 / -y, 0, 0],
        [0, 0, -(far + near) / (far - near), -(2 * far * near) / (far - near)],
        [0, 0, -1, 0],
    ])


def lookat(eye, at, up) -> torch.Tensor:
    """World -> camera view matrix."""
    eye, at, up = _f32(eye), _f32(at), _f32(up)
    f = at - eye
    f = f / torch.linalg.norm(f)
    r = torch.linalg.cross(f, up / torch.linalg.norm(up))
    r = r / torch.linalg.norm(r)
    u = torch.linalg.cross(r, f)
    return torch.stack([
        torch.cat([r, -torch.dot(r, eye)[None]]),
        torch.cat([u, -torch.dot(u, eye)[None]]),
        torch.cat([-f, torch.dot(f, eye)[None]]),
        _f32([0.0, 0.0, 0.0, 1.0]),
    ])


def _eye_dir(azimuth_deg, elevation_deg) -> torch.Tensor:
    # elevation measured from the +y pole (90 deg = equator)
    az = torch.deg2rad(_f32(azimuth_deg))
    el = torch.deg2rad(_f32(elevation_deg))
    return torch.stack([torch.sin(el) * torch.cos(az), torch.cos(el),
                        torch.sin(el) * torch.sin(az)])


def spherical_camera(azimuth_deg, elevation_deg, distance,
                     fovy_deg: float = 30.0, near: float = 0.1,
                     far: float = 1000.0):
    """Camera on a sphere looking at the origin.  Returns (mvp (4, 4),
    campos (3,))."""
    eye = distance * _eye_dir(azimuth_deg, elevation_deg)
    view = lookat(eye, torch.zeros(3), _f32([0.0, 1.0, 0.0]))
    proj = perspective(math.radians(fovy_deg), 1.0, near, far)
    return proj @ view, eye


def view_rotation(azimuth_deg, elevation_deg) -> torch.Tensor:
    """3x3 world -> camera rotation of `spherical_camera`'s pose."""
    eye = _eye_dir(azimuth_deg, elevation_deg)
    return lookat(eye, torch.zeros(3), _f32([0.0, 1.0, 0.0]))[:3, :3]


def canonical_normal_rotation(azimuth_deg, elevation_deg) -> torch.Tensor:
    """Q = R0^T R_c: world vectors as seen from the train split's pinned
    camera (az = 0, el = 90) when the camera is at (az, el); the identity
    at the pinned pose."""
    r0 = view_rotation(0.0, 90.0)
    return r0.T @ view_rotation(azimuth_deg, elevation_deg)


def fov_to_intrinsics(fov_deg: float) -> torch.Tensor:
    """Normalised pinhole intrinsics."""
    focal = 1.0 / math.tan(math.radians(fov_deg) / 2) / 2.0
    return _f32([[focal, 0, 0.5], [0, focal, 0.5], [0, 0, 1]])
