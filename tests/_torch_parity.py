"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

The same seeded numpy inputs go through the JAX function (on the CPU, as
the JAX package's own tests run it) and its counterpart in
`orbslam2_tpu_torch`, and the outputs are compared as numpy arrays.
"""

from __future__ import annotations

import fcntl
import os
import pickle

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


def random_xi(rng, n, rot=0.5, trans=2.0):
    """n se3 tangents (rotation, translation) uniform in +-rot, +-trans."""
    return np.concatenate(
        [rng.uniform(-rot, rot, (n, 3)), rng.uniform(-trans, trans, (n, 3))], axis=1
    ).astype(np.float32)


def random_descs(rng, n, ties=False):
    """n 256-bit descriptors as 8 uint32 words; `ties`: few distinct words,
    so many equal distances."""
    if ties:
        return rng.choice(np.array([0, 1, 3, 0xFFFFFFFF, 0x80000000], np.uint32), (n, 8))
    return rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)


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


# the matcher parity tests (tests/test_torch_matchers.py, test_torch_k3_gates.py)


def matcher_pair(n_features=600):
    """(world, [left, right]) of one rendered SyntheticWorld stereo pair:
    per eye the ORB keypoints the port extracts (uv, oct, desc as uint32,
    valid, angle), as numpy arrays."""
    from orbslam2_tpu_torch.datasets.synthetic import SyntheticWorld
    from orbslam2_tpu_torch.ops import orb

    world = SyntheticWorld(n_points=900, seed=7, baseline=0.2)
    imL, imR = world.render_stereo(world.trajectory(3, step=0.06)[2])
    f = orb.extract(torch.from_numpy(np.stack([imL, imR])).round(), orb.OrbParams(n_features=n_features))
    eyes = [dict(uv=f.uv[e].numpy(), oct=f.octave[e].numpy(), desc=f.desc[e].numpy().view(np.uint32),
                 valid=f.valid[e].numpy(), angle=f.angle[e].numpy()) for e in (0, 1)]
    return world, eyes


def on_boundary(rng, col_x, cols, r, n):
    """n rows placed from random columns of `cols`: a coordinate x with
    |fl(x_col - x)| == r exactly (first half) or one float32 ulp beyond
    (second half). Returns (column per row, x per row)."""
    f32 = np.float32
    r = f32(r)
    picks, xs = [], []
    for j in rng.permutation(cols):
        s = f32(rng.choice([-1.0, 1.0]))
        c = f32(col_x[j])
        x = f32(c - s * r)
        if np.abs(f32(c - x)) != r:
            continue
        if len(xs) >= n // 2:
            x = np.nextafter(x, f32(-s * np.inf))
            assert np.abs(f32(c - x)) > r
        picks.append(j)
        xs.append(x)
        if len(xs) == n:
            return np.array(picks), np.array(xs, f32)
    raise AssertionError("not enough boundary rows")


def flip_bits(rng, desc, p=0.5):
    """uint32 descriptors with one random bit flipped in a share p of words."""
    flips = rng.integers(0, 32, desc.shape).astype(np.uint32)
    return desc ^ ((np.uint32(1) << flips) * (rng.uniform(size=desc.shape) < p)).astype(np.uint32)


def jax_and_torch(jfn, tfn, args, descs, *tail):
    """jfn under jax.jit (one compile, not one per op) and tfn on the same
    arguments; `descs` are the positions of uint32 descriptor arrays."""
    import jax

    jargs, targs = [], []
    for i, a in enumerate(args):
        j, t = desc_both(a) if i in descs else both(a)
        jargs.append(j)
        targs.append(t)
    return jax.jit(lambda *a: jfn(*a, *tail))(*jargs), tfn(*targs, *tail)


def projected(rng, eye, n):
    """n projected points made from keypoints: (pick, uv, oct, desc)."""
    pick = rng.choice(np.nonzero(eye["valid"])[0], n, replace=False)
    uv = (eye["uv"][pick] + rng.normal(0, 2.0, (n, 2))).astype(np.float32)
    octv = np.clip(eye["oct"][pick] + rng.integers(-1, 2, n), 0, 7).astype(np.int32)
    return pick, uv, octv, flip_bits(rng, eye["desc"][pick])


def shared_run(tmp_path_factory, name: str, make):
    """make()'s result (plain, picklable data), made once per pytest session
    by its first caller under a file lock and read back by the others: the
    xdist workers of one session share the parent of their temporary
    directories."""
    base = tmp_path_factory.getbasetemp()
    where = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    path = where / f"{name}.pkl"
    with open(where / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if path.exists():
                with open(path, "rb") as f:
                    return pickle.load(f)
            out = make()
            part = path.with_suffix(".part")
            with open(part, "wb") as f:
                pickle.dump(out, f)
            os.replace(part, path)
            return out
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def frontend_pair():
    """tests/test_torch_frontend.py's stereo pair (frame 2 of the world of
    tests/test_tracking.py, rounded) [2, H, W] float32, and its world."""
    from orbslam2_tpu_torch.datasets.synthetic import SyntheticWorld

    world = SyntheticWorld(n_points=900, seed=7, baseline=0.2)
    imL, imR = world.render_stereo(world.trajectory(3, step=0.06)[2])
    return world, np.stack([np.rint(imL), np.rint(imR)]).astype(np.float32)


def jax_frontend_on_pair():
    """The JAX package's front end on `frontend_pair()`, as numpy: its
    FrameFeatures and the extractor's features of both eyes."""
    import jax

    from orbslam2_tpu import config as jax_config
    from orbslam2_tpu.ops import orb as jorb
    from orbslam2_tpu.slam.frontend import Frontend as JaxFrontend

    world, images = frontend_pair()
    jf = JaxFrontend(slam_config(world, jax_config))
    fj = jax.jit(lambda im: jorb.extract(im, jf.orb_params))(images)
    return jax.device_get((jf._process(images), fj))
