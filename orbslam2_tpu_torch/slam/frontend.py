"""Per-frame front end: ORB extraction + stereo matching.

Port of orbslam2_tpu/slam/frontend.py (reference Frame construction,
src/Frame.cpp:98-135). `Frontend.features_body` takes the stereo pair as
one [2, H, W] float32 tensor on the frontend's device and returns the
left eye's `FrameFeatures` with stereo depth; `features_mono` takes one
image [1, H, W] (K1 and K2 launched with one image) and returns its
features with no depth. With a distortion coefficient in the camera, the
keypoints are undistorted (`ops/undistort.py`, reference
Frame::UndistortKeyPoints) after stereo matching, which works on the
rectified pair's raw coordinates, as the JAX package does.
"""

from __future__ import annotations

import functools
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import convert
from ..config import SlamConfig
from ..geometry import camera as camera_mod
from ..ops import matchers, orb, undistort


class FrameFeatures(NamedTuple):
    """Device tensors: left-eye features + stereo depth. Capacity N."""

    uv: torch.Tensor  # [N,2] level-0 coords
    octave: torch.Tensor  # [N] int32
    angle: torch.Tensor  # [N]
    response: torch.Tensor  # [N]
    desc: torch.Tensor  # [N,8] int32 (the JAX package's uint32 bits)
    valid: torch.Tensor  # [N] bool
    u_right: torch.Tensor  # [N] -1 if no stereo match
    depth: torch.Tensor  # [N] -1 if no stereo match


class Frontend:
    def __init__(self, config: SlamConfig, device="cuda"):
        c = config
        self.config = config
        self.device = torch.device(device)
        cc = c.camera
        self._cc = cc
        #: keypoint undistortion (reference Frame.cpp:471-503): only with a
        #: distortion coefficient (raw monocular cameras); rectified stereo
        #: has none
        self.has_distortion = any(abs(x) > 0 for x in (cc.k1, cc.k2, cc.p1, cc.p2, cc.k3))
        self.orb_params = orb.OrbParams(
            n_features=c.orb.n_features,
            n_levels=c.orb.n_levels,
            scale_factor=c.orb.scale_factor,
            ini_th=float(c.orb.ini_th_fast),
            min_th=float(c.orb.min_th_fast),
        )
        self.camera = camera_mod.make_camera(
            cc.fx, cc.fy, cc.cx, cc.cy, bf=cc.bf, width=cc.width, height=cc.height
        )
        self.scale_factors = torch.tensor(
            orb.scale_factors(self.orb_params), dtype=torch.float32, device=self.device
        )
        self.level_sigma2 = np.asarray(orb.level_sigma2(self.orb_params))
        self.inv_level_sigma2 = torch.tensor(1.0 / self.level_sigma2, dtype=torch.float32, device=self.device)
        self._bf = float(cc.bf)
        self._baseline = float(c.baseline)

    def features_body(self, images: torch.Tensor) -> FrameFeatures:
        """ORB extraction of both eyes + stereo matching; images [2,H,W]
        float32 on the frontend's device."""
        f = orb.extract(images, self.orb_params)
        sm = matchers.stereo_match(
            f.uv[0], f.octave[0], f.desc[0], f.valid[0],
            f.uv[1], f.octave[1], f.desc[1], f.valid[1],
            self.scale_factors, bf=self._bf, min_z=self._baseline,
        )
        return FrameFeatures(
            uv=self._undistort(f.uv[0]), octave=f.octave[0], angle=f.angle[0],
            response=f.response[0], desc=f.desc[0], valid=f.valid[0],
            u_right=sm.u_right, depth=sm.depth,
        )

    def features_mono(self, image: torch.Tensor) -> FrameFeatures:
        """ORB extraction of one image [1, H, W] float32 on the frontend's
        device; u_right and depth are -1."""
        f = orb.extract(image, self.orb_params)
        no_stereo = torch.full_like(f.response[0], -1.0)
        return FrameFeatures(
            uv=self._undistort(f.uv[0]), octave=f.octave[0], angle=f.angle[0],
            response=f.response[0], desc=f.desc[0], valid=f.valid[0],
            u_right=no_stereo, depth=no_stereo,
        )

    def _undistort(self, uv: torch.Tensor) -> torch.Tensor:
        if not self.has_distortion:
            return uv
        cc = self._cc
        return undistort.undistort_points(uv, cc.fx, cc.fy, cc.cx, cc.cy, cc.k1, cc.k2, cc.p1, cc.p2, cc.k3)

    def _images(self, *images) -> torch.Tensor:
        """numpy arrays or tensors -> one [n, H, W] float32 tensor on the
        device (a tensor already there is not copied to the host)."""
        stack = stack_images(*images)
        if isinstance(stack, np.ndarray):
            stack = torch.from_numpy(stack)
        return stack.to(self.device, torch.float32)

    def process(self, im_left, im_right) -> FrameFeatures:
        """Stereo pair (numpy arrays or tensors) -> FrameFeatures on the device."""
        return self.features_body(self._images(im_left, im_right))

    def process_mono(self, image) -> FrameFeatures:
        """One image (numpy array or tensor) -> FrameFeatures on the device."""
        return self.features_mono(self._images(image))

    def measure_stage_split(self, im_left, im_right, reps: int = 20):
        """The extraction-only program (`orb.extract` over both images: K1,
        K2) against the whole `features_body` (K1, K2, K3 `stereo`) on one
        stereo pair, each after one warm-up call, each timed call ending
        synchronised with the device (orbslam2_tpu/slam/frontend.py::
        measure_stage_split; the reference times the two as separate
        stages, Frame.cpp:112-132). Returns (orb_seconds[reps],
        full_seconds[reps]); their difference is stereo matching."""
        images = self._images(im_left, im_right)
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)

        def timed(fn):
            t0 = time.perf_counter()
            fn(images)
            sync()
            return time.perf_counter() - t0

        extract = functools.partial(orb.extract, params=self.orb_params)
        for warm_up in (extract, self.features_body):
            timed(warm_up)
        t_orb, t_full = [], []
        for _ in range(reps):
            t_orb.append(timed(extract))
            t_full.append(timed(self.features_body))
        return t_orb, t_full


def stack_images(*images):
    """Images of one size -> one [n, H, W]: a tensor, where it lies, when
    every image is a tensor, else a numpy array."""
    if all(isinstance(im, torch.Tensor) for im in images):
        return torch.stack(images)
    return np.stack([np.asarray(im) for im in images])


class FrameHost:
    """Host-side (numpy) snapshot of a processed frame, for map admin.

    The host arrays are fetched lazily: the per-frame hot path reads only
    the step outputs, while keyframe creation touches any field and
    triggers ONE pass that copies every field to the host. Descriptors
    come back as uint32 words, the map's dtype.
    """

    _HOST_FIELDS = FrameFeatures._fields

    def __init__(self, features: FrameFeatures, timestamp: float, frame_id: int,
                 eager: bool = True):
        self.timestamp = timestamp
        self.frame_id = frame_id
        self._dev = features
        if eager:
            self._fetch_host()
        n = features.valid.shape[0]
        self.point_ids = np.full(n, -1, np.int64)  # matched map point per kp
        #: localization mode: kp index -> world position of the
        #: visual-odometry point it matched (never enters the map)
        self.temp_points: dict = {}
        self.outlier = np.zeros(n, bool)
        self.Tcw: Optional[np.ndarray] = None  # [4,4] float32

    def _fetch_host(self):
        self.attach_host([t.cpu() for t in self._dev])

    def attach_host(self, host):
        """Install the features already copied to the host (CPU tensors in
        `FrameFeatures` order): the pipelined tracker copies them together
        with the step outputs (JAX `FrameHost.attach_host`)."""
        for name, t in zip(FrameHost._HOST_FIELDS, host):
            self.__dict__[name] = convert.desc_to_numpy(t) if name == "desc" else t.numpy()

    def __getattr__(self, name):
        # only reached when normal lookup fails: the first host access on a
        # lazily constructed frame triggers the batched fetch
        if name in FrameHost._HOST_FIELDS and "_dev" in self.__dict__:
            self._fetch_host()
            return self.__dict__[name]
        raise AttributeError(f"{type(self).__name__!r} object has no attribute {name!r}")

    @property
    def n_keypoints(self) -> int:
        return int(self.valid.sum())

    @property
    def dev(self) -> FrameFeatures:
        return self._dev
