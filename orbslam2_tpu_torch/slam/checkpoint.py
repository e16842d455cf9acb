"""Map checkpoint / resume.

Port of orbslam2_tpu/slam/checkpoint.py (the reference leaves SaveMap /
LoadMap as a TODO, include/System.hpp:109-111). The map serializes to one
compressed npz in the JAX package's format (`version=1`, the same keys,
dtypes and shapes): keyframe poses, feature snapshots, the point table,
the observation COO and the graph arrays. A map saved by either package
loads in the other.

`load_map` rebuilds each keyframe's `FrameHost` from the host arrays and
uploads its `FrameFeatures` to `device` once (descriptors through
`convert.desc_to_torch`), under the map lock. `System.load_map` then
indexes every loaded keyframe in the keyframe database, so a System that
loads a map relocalizes and closes loops against the loaded keyframes too.
The JAX package leaves its database empty after a load.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import convert
from .frontend import FrameFeatures, FrameHost
from .map import SlamMap

#: the port's dtype of each FrameFeatures field, for the upload
_FEATURE_DTYPES = dict(uv=torch.float32, octave=torch.int32, angle=torch.float32, response=torch.float32,
                       valid=torch.bool, u_right=torch.float32, depth=torch.float32)


def save_map(m: SlamMap, path: str):
    kfs = sorted(m.kf_valid)
    pts = [int(p) for p in m.pt_ids()]
    N = m.n_kp

    def stack_frames(attr):
        return np.stack([getattr(m.kf_frame[k], attr) for k in kfs]) if kfs else np.zeros((0,))

    obs_pt, obs_kf, obs_idx = [], [], []
    for p in pts:
        for k, idx in m.pt_obs[p].items():
            # a culled keyframe leaves no observation (SlamMap.remove_keyframe)
            assert k in m.kf_valid, f"point {p} is observed by the dead keyframe {k}"
            obs_pt.append(p)
            obs_kf.append(k)
            obs_idx.append(idx)

    np.savez_compressed(
        path,
        version=1,
        n_kp=N,
        n_levels=m.n_levels,
        scale_factor=m.scale_factor,
        kf_ids=np.array(kfs, np.int64),
        kf_pose=np.stack([m.kf_pose[k] for k in kfs]) if kfs else np.zeros((0, 4, 4)),
        kf_frame_id=np.array([m.kf_frame_id[k] for k in kfs], np.int64),
        kf_timestamp=np.array([m.kf_timestamp[k] for k in kfs]),
        kf_point=np.stack([m.kf_point[k] for k in kfs]) if kfs else np.zeros((0, N)),
        kf_parent=np.array([m.parent.get(k, -1) for k in kfs], np.int64),
        f_uv=stack_frames("uv"),
        f_octave=stack_frames("octave"),
        f_angle=stack_frames("angle"),
        f_response=stack_frames("response"),
        f_desc=stack_frames("desc"),
        f_valid=stack_frames("valid"),
        f_u_right=stack_frames("u_right"),
        f_depth=stack_frames("depth"),
        pt_ids=np.array(pts, np.int64),
        pt_pos=m.pt_pos[np.asarray(pts, np.int64)],
        pt_desc=m.pt_desc[np.asarray(pts, np.int64)],
        pt_normal=m.pt_normal[np.asarray(pts, np.int64)],
        pt_min_dist=m.pt_min_dist[np.asarray(pts, np.int64)],
        pt_max_dist=m.pt_max_dist[np.asarray(pts, np.int64)],
        pt_ref_kf=m.pt_ref_kf[np.asarray(pts, np.int64)],
        obs_pt=np.array(obs_pt, np.int64),
        obs_kf=np.array(obs_kf, np.int64),
        obs_idx=np.array(obs_idx, np.int64),
        origins=np.array(m.keyframe_origins, np.int64),
    )


def _upload(frame: FrameHost, device) -> FrameFeatures:
    """The frame's host arrays as FrameFeatures on `device`."""
    fields = {"desc": convert.desc_to_torch(frame.desc, device)}
    for name, dtype in _FEATURE_DTYPES.items():
        fields[name] = torch.from_numpy(np.ascontiguousarray(getattr(frame, name))).to(device, dtype)
    return FrameFeatures(**fields)


def load_map(m: SlamMap, path: str, device="cuda"):
    z = np.load(path)
    with m.lock:
        m.clear()
        kfs = z["kf_ids"]
        for i, k in enumerate(kfs):
            k = int(k)
            frame = FrameHost.__new__(FrameHost)
            frame.timestamp = float(z["kf_timestamp"][i])
            frame.frame_id = int(z["kf_frame_id"][i])
            frame.uv = z["f_uv"][i]
            frame.octave = z["f_octave"][i]
            frame.angle = z["f_angle"][i]
            frame.response = z["f_response"][i]
            frame.desc = z["f_desc"][i]
            frame.valid = z["f_valid"][i]
            frame.u_right = z["f_u_right"][i]
            frame.depth = z["f_depth"][i]
            frame.point_ids = z["kf_point"][i].astype(np.int64).copy()
            frame.outlier = np.zeros(len(frame.valid), bool)
            frame.Tcw = z["kf_pose"][i]
            frame.temp_points = {}
            frame._dev = _upload(frame, device)
            m.kf_pose[k] = z["kf_pose"][i].astype(np.float32)
            m.kf_frame[k] = frame
            m.kf_point[k] = frame.point_ids.copy()
            m.kf_frame_id[k] = frame.frame_id
            m.kf_timestamp[k] = frame.timestamp
            m.kf_valid.add(k)
            m.covis[k] = {}
            m.children[k] = set()
            m.loop_edges[k] = set()
            m.kf_first_connection[k] = False
            par = int(z["kf_parent"][i])
            if par >= 0:
                m.parent[k] = par
        for k in list(m.parent):
            m.children.setdefault(m.parent[k], set()).add(k)

        pts = z["pt_ids"].astype(np.int64)
        if len(pts):
            m.ensure_pt_capacity(int(pts.max()) + 1)
            m.pt_pos[pts] = z["pt_pos"]
            m.pt_desc[pts] = z["pt_desc"].astype(np.uint32)
            m.pt_normal[pts] = z["pt_normal"]
            m.pt_min_dist[pts] = z["pt_min_dist"]
            m.pt_max_dist[pts] = z["pt_max_dist"]
            m.pt_ref_kf[pts] = z["pt_ref_kf"]
            m.pt_first_kf_id[pts] = z["pt_ref_kf"]
            m.pt_visible[pts] = 1
            m.pt_found[pts] = 1
            for p in pts:
                m.pt_obs[int(p)] = {}
                m.pt_valid.add(int(p))
        for p, k, idx in zip(z["obs_pt"], z["obs_kf"], z["obs_idx"]):
            p, k, idx = int(p), int(k), int(idx)
            m.pt_obs[p][k] = idx
            m.pt_nobs[p] += m._obs_weight(k, idx)
        m.rebuild_obs_mirror()
        m._next_kf = int(kfs.max()) + 1 if len(kfs) else 0
        m._next_pt = int(pts.max()) + 1 if len(pts) else 0
        m.keyframe_origins = [int(x) for x in z["origins"]]
        for k in m.kf_valid:
            m.update_connections(int(k))
