"""Sim(3) similarity transforms for loop closing.

Port of orbslam2_tpu/geometry/sim3.py (reference Thirdparty/g2o/g2o/types/
sim3.h), used by the Sim3 solver and the essential graph. A Sim3 is a
tuple of tensors (R [..., 3, 3], t [..., 3], s [...]) acting as
x -> s * R @ x + t. Tangent convention (7-vector): (omega, upsilon, sigma),
rotation, translation, log-scale, with left-multiplicative retraction.
Every function keeps its inputs' dtype and device; the solvers call them
in float64.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import se3


class Sim3(NamedTuple):
    R: torch.Tensor  # [..., 3, 3]
    t: torch.Tensor  # [..., 3]
    s: torch.Tensor  # [...]

    def matrix(self) -> torch.Tensor:
        """[..., 4, 4] with sR in the upper block."""
        return se3.from_Rt(self.s[..., None, None] * self.R, self.t)

    def to(self, *args, **kwargs) -> "Sim3":
        return Sim3(*(x.to(*args, **kwargs) for x in self))


def identity(batch_shape=(), dtype=torch.float32, device="cpu") -> Sim3:
    return Sim3(
        R=torch.eye(3, dtype=dtype, device=device).expand(*batch_shape, 3, 3).clone(),
        t=torch.zeros((*batch_shape, 3), dtype=dtype, device=device),
        s=torch.ones(batch_shape, dtype=dtype, device=device),
    )


def from_se3(T: torch.Tensor, s=None) -> Sim3:
    if s is None:
        s = torch.ones(T.shape[:-2], dtype=T.dtype, device=T.device)
    return Sim3(R=se3.rotation(T), t=se3.translation(T), s=s)


def to_se3(S: Sim3) -> torch.Tensor:
    """Project to SE(3): keep R, divide the translation by s (reference
    LoopClosing.cpp:463-466: Tiw = [R | t/s])."""
    return se3.from_Rt(S.R, S.t / S.s[..., None])


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...j->...i", M, v)


def apply(S: Sim3, p: torch.Tensor) -> torch.Tensor:
    return S.s[..., None] * _mv(S.R, p) + S.t


def compose(A: Sim3, B: Sim3) -> Sim3:
    return Sim3(R=A.R @ B.R, t=A.s[..., None] * _mv(A.R, B.t) + A.t, s=A.s * B.s)


def inverse(S: Sim3) -> Sim3:
    Rinv = S.R.transpose(-1, -2)
    sinv = 1.0 / S.s
    return Sim3(R=Rinv, t=-sinv[..., None] * _mv(Rinv, S.t), s=sinv)


def _w_matrix(w: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """exp's linear map u -> t: A I + B W + C W^2 [..., 3, 3], the
    closed-form W matrix (Strasdat's thesis, g2o sim3.h), with the JAX
    package's small-sigma (|sigma| < 1e-5) and small-angle (theta^2 <
    1e-10) limits. The JAX package's `log` probes `exp` with the three
    basis vectors for it, which gives these same columns."""
    s = torch.exp(sigma)
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-16))
    W = se3.hat(w)
    W2 = W @ W
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)

    small_sigma = torch.abs(sigma) < 1e-5
    small_theta = theta2 < 1e-10

    A_gen = (s - 1.0) / torch.where(small_sigma, 1.0, sigma)
    A = torch.where(small_sigma, 1.0 + sigma / 2.0 + sigma**2 / 6.0, A_gen)
    a = s * torch.sin(theta)
    b = s * torch.cos(theta)
    c2 = sigma**2 + theta2
    c2 = torch.where(c2 < 1e-12, 1.0, c2)
    B_big = (a * sigma + (1.0 - b) * theta) / (theta * c2)
    C_big = (A - ((b - 1.0) * sigma + a * theta) / c2) / torch.where(small_theta, 1.0, theta2)
    # theta -> 0 (sigma arbitrary)
    sig_safe = torch.where(small_sigma, 1.0, sigma)
    B_sm = torch.where(small_sigma, 0.5 + sigma / 3.0, ((sigma - 1.0) * s + 1.0) / sig_safe**2)
    C_sm = torch.where(small_sigma, 1.0 / 6.0 + sigma / 8.0,
                       ((0.5 * sig_safe**2 - sig_safe + 1.0) * s - 1.0) / sig_safe**3)
    B = torch.where(small_theta, B_sm, B_big)
    C = torch.where(small_theta, C_sm, C_big)
    return A[..., None, None] * eye + B[..., None, None] * W + C[..., None, None] * W2


def exp(xi: torch.Tensor) -> Sim3:
    """sim(3) exp of [..., 7] = (omega, upsilon, sigma): t = W(omega,
    sigma) upsilon (`_w_matrix`)."""
    w, u, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    return Sim3(R=se3.exp_so3(w), t=_mv(_w_matrix(w, sigma), u), s=torch.exp(sigma))


def log(S: Sim3) -> torch.Tensor:
    """Inverse of `exp`: solves exp's W-matrix system for upsilon."""
    w = se3.log_so3(S.R)
    sigma = torch.log(S.s)
    u = torch.linalg.solve_ex(_w_matrix(w, sigma), S.t[..., None])[0][..., 0]
    return torch.cat([w, u, sigma[..., None]], dim=-1)


def retract(S: Sim3, xi: torch.Tensor) -> Sim3:
    return compose(exp(xi), S)
