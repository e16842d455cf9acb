"""Pinhole stereo camera model: projection, unprojection, frustum tests.

Port of orbslam2_tpu/geometry/camera.py (reference Frame.cpp:336-392
isInFrustum, :878-893 UnprojectStereo). The intrinsics are Python floats:
they are configuration, not device data.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import se3


class Camera(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    bf: float  # baseline * fx (stereo); 0 for mono
    width: int
    height: int


def make_camera(fx, fy, cx, cy, bf=0.0, width=752, height=480) -> Camera:
    """Intrinsics rounded to float32 once, as the JAX package stores them."""
    f32 = lambda v: float(torch.tensor(v, dtype=torch.float32))  # noqa: E731
    return Camera(f32(fx), f32(fy), f32(cx), f32(cy), f32(bf), int(width), int(height))


def project(cam: Camera, pc: torch.Tensor) -> torch.Tensor:
    """Camera-frame points [...,3] -> pixel (u, v) [...,2]; caller checks z>0."""
    z = pc[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    u = cam.fx * pc[..., 0] * inv_z + cam.cx
    v = cam.fy * pc[..., 1] * inv_z + cam.cy
    return torch.stack([u, v], dim=-1)


def project_stereo(cam: Camera, pc: torch.Tensor) -> torch.Tensor:
    """Camera-frame points -> (u, v, uR) [...,3], the stereo measurement."""
    uv = project(cam, pc)
    z = pc[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    ur = uv[..., 0] - cam.bf * inv_z
    return torch.cat([uv, ur[..., None]], dim=-1)


def unproject_stereo(cam: Camera, u, v, depth) -> torch.Tensor:
    """Pixel + stereo depth -> camera-frame 3D point [...,3]."""
    x = (u - cam.cx) * depth / cam.fx
    y = (v - cam.cy) * depth / cam.fy
    return torch.stack([x, y, depth * torch.ones_like(x)], dim=-1)


def in_image(cam: Camera, uv: torch.Tensor, min_x=0.0, min_y=0.0) -> torch.Tensor:
    u, v = uv[..., 0], uv[..., 1]
    return (u >= min_x) & (u < cam.width) & (v >= min_y) & (v < cam.height)


def is_in_frustum(cam, Tcw, pw, normal, min_dist, max_dist, view_cos_limit: float = 0.5):
    """Batched reference Frame::isInFrustum. Returns (visible_mask, uv, ur,
    dist, view_cos)."""
    pc = se3.transform(Tcw, pw)
    z = pc[..., 2]
    uvr = project_stereo(cam, pc)
    uv, ur = uvr[..., :2], uvr[..., 2]
    Ow = se3.translation(se3.inverse(Tcw))
    po = pw - Ow
    dist = torch.linalg.vector_norm(po, dim=-1)
    view_cos = torch.sum(po * normal, dim=-1) / torch.clamp(dist, min=1e-9)
    visible = (
        (z > 0.0)
        & in_image(cam, uv)
        & (dist >= min_dist)
        & (dist <= max_dist)
        & (view_cos > view_cos_limit)
    )
    return visible, uv, ur, dist, view_cos
