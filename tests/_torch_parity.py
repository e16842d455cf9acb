"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

The same seeded numpy inputs go through the JAX function (on the CPU, as
the JAX package's own tests run it) and its counterpart in
`orbslam2_tpu_torch`, and the outputs are compared as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

# six xdist workers share the machine: one intra-op thread each
torch.set_num_threads(1)


def both(a, dtype=None):
    """numpy array -> (jax array, torch CPU tensor) with the same values."""
    import jax.numpy as jnp

    a = np.asarray(a) if dtype is None else np.asarray(a, dtype)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def desc_both(words: np.ndarray):
    """uint32 descriptor words -> (jax uint32 array, torch int32 tensor)."""
    import jax.numpy as jnp

    words = np.ascontiguousarray(words, np.uint32)
    return jnp.asarray(words), torch.from_numpy(words.view(np.int32).copy())


def np_of(x) -> np.ndarray:
    """JAX array or torch tensor -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def slam_config(world, config_module):
    """The configuration of tests/test_tracking.py for `world`, as a
    `SlamConfig` of `config_module` (the JAX package's or the port's)."""
    m = config_module
    return m.SlamConfig(
        camera=m.CameraConfig(
            fx=world.fx, fy=world.fy, cx=world.cx, cy=world.cy,
            bf=world.bf, width=world.width, height=world.height, fps=20.0,
        ),
        orb=m.OrbConfig(n_features=1200),
    )


def rot_err(Ra: np.ndarray, Rb: np.ndarray) -> float:
    """Angle (rad) of Ra^T Rb, from its skew part and trace (accurate for
    tiny angles, where arccos of the trace alone is not)."""
    M = Ra.astype(np.float64).T @ Rb.astype(np.float64)
    s = 0.5 * np.linalg.norm([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]])
    return float(np.arctan2(s, (np.trace(M) - 1.0) / 2.0))
