"""Synthetic textured stereo world for tests and benchmarks.

The reference validates end-to-end against EuRoC golden runs
(reference result/ + result_analysis.py). EuRoC imagery is not available
in this environment, so tests render a controlled 3D world instead:
textured square sprites at known 3D positions, projected into a rectified
stereo pair along a known trajectory. Each sprite is drawn fronto-parallel
and shifted by its true disparity in the right eye, so sprite corners are
geometrically consistent stereo features with exactly known ground truth.

Rendering is host-side numpy (test-time IO, not a compute path).

This file is a copy of orbslam2_tpu/datasets/synthetic.py: the JAX
package's copy imports its camera module, which imports JAX. This one
builds its camera from the port's `geometry/camera.py` and renders the
same images byte for byte.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy import ndimage

from ..geometry import camera as cam_mod


@dataclass
class SyntheticWorld:
    n_points: int = 700
    seed: int = 0
    width: int = 752
    height: int = 480
    fx: float = 458.654
    fy: float = 457.296
    cx: float = 367.215
    cy: float = 248.375
    baseline: float = 0.11  # meters (EuRoC-like; bf = fx * b ≈ 50.4)
    depth_range: tuple = (4.0, 25.0)
    lateral_extent: float = 14.0
    vertical_extent: float = 8.0
    sprite_world_size: float = 0.9  # meters; on-screen size = f*s/z
    cylinder_radius: float = 0.0  # >0: points on a cylinder wall (loop worlds)
    #: fraction of cylinder-world sprites on an inner ring at 0.55*R:
    #: gives the scene CLOSE structure (depth < ThDepth*baseline), without
    #: which the reference's need_close keyframe rule (Tracking.cpp:
    #: 846-861) fires on every frame — real scenes have foreground
    near_fraction: float = 0.0
    #: photometric realism (VERDICT r4 task 7): per-frame sensor noise
    #: sigma (grey levels) and slow exposure (gain) drift amplitude —
    #: exercises the FAST 20->7 fallback and descriptor stability the way
    #: real imagery does (reference ORBextractor.cpp:702-766)
    noise_sigma: float = 0.0
    exposure_drift: float = 0.0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        n = self.n_points
        xs = rng.uniform(-self.lateral_extent, self.lateral_extent, n)
        ys = rng.uniform(-self.vertical_extent, self.vertical_extent, n)
        # depth is a SMOOTH surface z(x, y): neighboring sprites share depth,
        # so their overlap does not shear under camera motion (a deep random
        # cloud of billboards destroys descriptor stability in a way no real
        # scene — which is locally continuous — does).
        d0, d1 = self.depth_range
        mid, amp = 0.5 * (d0 + d1), 0.5 * (d1 - d0)
        ph = rng.uniform(0, 2 * np.pi, 4)
        if self.cylinder_radius > 0:
            # loop world: sprites on a smooth-radius cylinder wall around
            # the origin (camera circuits inside, looking along the tangent)
            theta = rng.uniform(0, 2 * np.pi, n)
            rr = self.cylinder_radius * (
                1.0
                + 0.10 * np.sin(3 * theta + ph[0]) * np.cos(0.4 * ys + ph[1])
                + 0.06 * np.sin(7 * theta + ph[2])
            )
            n_near = int(round(self.near_fraction * n))
            if n_near:
                rr[:n_near] = self.cylinder_radius * (
                    0.55 + 0.06 * np.sin(5 * theta[:n_near] + ph[3])
                )
            self.points = np.stack(
                [rr * np.sin(theta), ys, rr * np.cos(theta)], axis=1
            ).astype(np.float64)
        else:
            zs = mid + amp * (
                0.6 * np.sin(0.35 * xs + ph[0]) * np.cos(0.45 * ys + ph[1])
                + 0.4 * np.sin(0.15 * xs + 0.25 * ys + ph[2])
            )
            self.points = np.stack([xs, ys, zs], axis=1).astype(np.float64)
        # per-sprite texture: continuous random blocks + an asymmetric
        # gradient so the intensity centroid (ORB angle) is well defined
        blocks = rng.uniform(0.0, 1.0, size=(n, 6, 6))
        gdir = rng.uniform(0, 2 * np.pi, n)
        gx, gy = np.cos(gdir), np.sin(gdir)
        yy, xx = np.mgrid[0:6, 0:6] / 5.0 - 0.5
        grad = gx[:, None, None] * xx + gy[:, None, None] * yy  # [-.7,.7]
        self.textures = np.clip(0.6 * blocks + 0.55 + 0.6 * grad, 0.0, 1.0)
        self.tex_lo = rng.uniform(10, 60, n)
        self.tex_hi = rng.uniform(180, 245, n)
        # smooth background: upsampled coarse noise
        coarse = rng.uniform(90, 150, (self.height // 40 + 2, self.width // 40 + 2))
        ys = np.linspace(0, coarse.shape[0] - 1.001, self.height)
        xs = np.linspace(0, coarse.shape[1] - 1.001, self.width)
        yi, xi = np.floor(ys).astype(int), np.floor(xs).astype(int)
        fy_, fx_ = ys - yi, xs - xi
        bg = (
            coarse[yi][:, xi] * (1 - fy_)[:, None] * (1 - fx_)[None, :]
            + coarse[yi + 1][:, xi] * fy_[:, None] * (1 - fx_)[None, :]
            + coarse[yi][:, xi + 1] * (1 - fy_)[:, None] * fx_[None, :]
            + coarse[yi + 1][:, xi + 1] * fy_[:, None] * fx_[None, :]
        )
        self.background = bg

    @property
    def bf(self) -> float:
        return self.fx * self.baseline

    def camera(self):
        return cam_mod.make_camera(
            self.fx, self.fy, self.cx, self.cy, bf=self.bf,
            width=self.width, height=self.height,
        )

    def trajectory(self, n_frames: int, step: float = 0.05):
        """Forward motion with gentle lateral sway and yaw.

        Returns list of Tcw (world->camera) 4x4 float32.
        """
        poses = []
        for i in range(n_frames):
            t = i * step
            # camera center in world coords
            c = np.array([0.6 * np.sin(0.12 * i), 0.15 * np.sin(0.07 * i), t])
            yaw = 0.03 * np.sin(0.05 * i)
            cy_, sy_ = np.cos(yaw), np.sin(yaw)
            Rwc = np.array([[cy_, 0, sy_], [0, 1, 0], [-sy_, 0, cy_]])
            Rcw = Rwc.T
            tcw = -Rcw @ c
            T = np.eye(4)
            T[:3, :3] = Rcw
            T[:3, 3] = tcw
            poses.append(T.astype(np.float32))
        return poses

    def trajectory_out_and_back(self, n_frames: int, length: float = 20.0):
        """Lateral sweep along the point wall and back to the start — the
        start view leaves covisibility mid-run and is revisited at the end,
        which is the geometry loop closure needs."""
        poses = []
        for i in range(n_frames):
            phase = i / (n_frames - 1)
            x = length * 0.5 * (1.0 - np.cos(2 * np.pi * phase))
            c = np.array([x, 0.1 * np.sin(0.2 * i), 0.0])
            T = np.eye(4)
            T[:3, 3] = -c
            poses.append(T.astype(np.float32))
        return poses

    def trajectory_circuit(
        self,
        n_frames: int,
        radius: float = 4.0,
        center=(0.0, 0.0),
        direction: float = 1.0,
        phase0: float = 0.0,
    ):
        """Full circle inside the cylinder world, camera looking along the
        tangent — start region leaves view and is revisited only at the end
        through a different map region: a genuine loop closure.

        center (x, z), direction (+1 counterclockwise / -1 clockwise) and
        phase0 generalize to off-origin circles so trajectories can chain
        several loops (see trajectory_figure8)."""
        cx, cz = center
        poses = []
        for i in range(n_frames):
            phi = direction * 2 * np.pi * i / (n_frames - 1) + phase0
            c = np.array([cx + radius * np.sin(phi), 0.05 * np.sin(0.3 * i),
                          cz + radius * np.cos(phi)])
            # heading = d(center)/d(i), the travel direction
            z_cam = direction * np.array([np.cos(phi), 0.0, -np.sin(phi)])
            y_cam = np.array([0.0, 1.0, 0.0])
            x_cam = np.cross(y_cam, z_cam)
            Rwc = np.stack([x_cam, y_cam, z_cam], axis=1)
            T = np.eye(4)
            T[:3, :3] = Rwc.T
            T[:3, 3] = -Rwc.T @ c
            poses.append(T.astype(np.float32))
        return poses

    def trajectory_figure8(
        self,
        n_lap: int = 240,
        radius_a: float = 4.0,
        radius_b: float = 2.5,
        lead_a: int = 61,
        margin_b: int = 50,
    ):
        """Two externally tangent circles traversed as a figure-8: lap the
        A-circle twice (its seam revisit closes loop #1), hand over at the
        tangency point — where the two circles share position AND heading,
        so the camera path is C^0/C^1 continuous — then lap the B-circle
        fully plus a margin (its seam revisit closes loop #2). Two
        GENUINELY distinct loop-closure events in one sequence: after the
        first closure merges the A laps, A revisits are covisible (no
        further event, correct SLAM behavior), while B's seam is new.

        A: center (0,0), counterclockwise. B: center (ra+rb, 0),
        clockwise, phased so B(0) is the tangency point with matching
        heading. Returns (poses, meta) with segment boundaries."""
        lap_a = self.trajectory_circuit(n_lap, radius=radius_a)
        lap_b = self.trajectory_circuit(
            n_lap, radius=radius_b, center=(radius_a + radius_b, 0.0),
            direction=-1.0, phase0=-np.pi / 2,
        )
        # A's tangency pass: phi = pi/2 at i = (n-1)/4 — lead_a should
        # cover it (default 61 ~= 90 deg of a 240-frame lap)
        poses = lap_a + lap_a[:lead_a] + lap_b + lap_b[:margin_b]
        meta = dict(
            n_lap=n_lap, lap1_end=n_lap, handover=n_lap + lead_a,
            lap_b_end=n_lap + lead_a + n_lap, n_frames=len(poses),
        )
        return poses, meta

    def render_stereo(self, Tcw: np.ndarray, return_id_map: bool = False):
        """Render (imL, imR) float32 [H,W] in 0..255 for camera pose Tcw.

        With return_id_map, also returns an int32 [H,W] map of which sprite
        index owns each left-image pixel (-1 background) — ground truth for
        association in tests.
        """
        H, W = self.height, self.width
        imL = self.background.copy()
        imR = self.background.copy()
        id_map = np.full((H, W), -1, np.int32)
        Rcw, tcw = Tcw[:3, :3].astype(np.float64), Tcw[:3, 3].astype(np.float64)
        pc = self.points @ Rcw.T + tcw
        z = pc[:, 2]
        order = np.argsort(-z)  # painter: far first
        for i in order:
            zi = z[i]
            if zi < 0.5:
                continue
            u = self.fx * pc[i, 0] / zi + self.cx
            v = self.fy * pc[i, 1] / zi + self.cy
            disp = self.bf / zi
            size = int(round(self.fx * self.sprite_world_size / zi))
            if size < 6:
                continue
            half = size // 2
            tex = np.kron(
                self.textures[i],
                np.ones((max(size // 6, 1), max(size // 6, 1))),
            )
            tex = tex[:size, :size]
            sprite = self.tex_lo[i] + tex * (self.tex_hi[i] - self.tex_lo[i])
            for img, uu in ((imL, u), (imR, u - disp)):
                # subpixel placement: bilinear-shift the sprite by the
                # fractional offset so stereo disparity is not quantized
                # to whole pixels by the renderer.
                rf = v - half
                cf = uu - half
                r0, c0 = int(np.floor(rf)), int(np.floor(cf))
                sh = ndimage.shift(
                    sprite, (rf - r0, cf - c0), order=1, mode="nearest"
                )
                r1, c1 = r0 + sh.shape[0], c0 + sh.shape[1]
                rr0, cc0 = max(r0, 0), max(c0, 0)
                rr1, cc1 = min(r1, H), min(c1, W)
                if rr1 <= rr0 or cc1 <= cc0:
                    continue
                img[rr0:rr1, cc0:cc1] = sh[
                    rr0 - r0 : rr1 - r0, cc0 - c0 : cc1 - c0
                ]
                if img is imL:
                    id_map[rr0:rr1, cc0:cc1] = i
        # camera PSF: real optics low-pass the scene, which is what keeps
        # BRIEF/IC-angle stable under sub-pixel motion. Without this, the
        # razor-sharp synthetic edges flip descriptor bits frame to frame.
        imL = ndimage.gaussian_filter(imL, 0.8)
        imR = ndimage.gaussian_filter(imR, 0.8)
        if self.noise_sigma > 0 or self.exposure_drift > 0:
            idx = self._n_rendered = getattr(self, "_n_rendered", 0) + 1
            rng2 = np.random.default_rng((self.seed << 20) ^ idx)
            gain = 1.0 + self.exposure_drift * np.sin(2 * np.pi * idx / 97.0)
            imL = imL * gain
            imR = imR * gain
            if self.noise_sigma > 0:
                imL = imL + rng2.normal(0.0, self.noise_sigma, imL.shape)
                imR = imR + rng2.normal(0.0, self.noise_sigma, imR.shape)
            imL = np.clip(imL, 0.0, 255.0)
            imR = np.clip(imR, 0.0, 255.0)
        if return_id_map:
            return imL.astype(np.float32), imR.astype(np.float32), id_map
        return imL.astype(np.float32), imR.astype(np.float32)

    def render_sequence(self, n_frames: int, step: float = 0.05):
        poses = self.trajectory(n_frames, step)
        frames = [self.render_stereo(T) for T in poses]
        return poses, frames
