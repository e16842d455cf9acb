"""The local-mapping parity sequence, shared by
tests/test_torch_local_mapping.py and tests/test_torch_local_mapping_jax.py.

The world of tests/test_local_mapping.py (seed 11, 1200 features): the
JAX package's tracker with its local mapper through frame 28, the port's
through all 45 frames, then 6 frames in localization mode; on the map of
frame 28 each package relocalizes the kidnapped view of frame 16 with the
same vocabulary (the JAX package's `vocab/train.py`, k = 8, depth 3, as
tests/test_relocalization.py trains it, carried across with
`convert.vocabulary_to_torch`). `relocalize` changes only the frame it is
given and its relocalizer's own seeded random stream, so the port
relocalizes on a copy of its map as it stood after frame 28
(`port_relocalization`) and its tracker runs on undisturbed.

The sequence is made in two parts, each once per session: the JAX
package's ("jax": its run, the vocabulary, its relocalization) and the
port's ("port": its run, with the copy of its map at frame 28). The two
files hold 4 and 2 tests, so xdist's `--dist loadfile` queue puts them
after tests/test_mesh_loop.py, on two workers: the port's file makes the
port part, the JAX file the JAX part and then reads (or, if the other
file has not started it, makes) the port part; each part is made under a
file lock in the session's temporary directory (shared by the xdist
workers) and left there as plain data.
"""

from __future__ import annotations

import copy
import threading
import types

import numpy as np
from _torch_parity import shared_run, slam_config

N_FRAMES = 45
N_PARITY = 29  # frames 0..28: the second local BA runs on frame 28
KIDNAPPED = 16  # the view shown to both relocalizers on frame 28's map
N_LOCALIZATION = 6  # frames tracked in localization mode after frame 44


def center(T):
    return -T[:3, :3].T.astype(np.float64) @ T[:3, 3]


def _pair(cfg_module, frontend_cls, map_cls, tracker_cls, mapper_cls, world, **kw):
    cfg = slam_config(world, cfg_module)
    frontend = frontend_cls(cfg, **kw)
    slam_map = map_cls(cfg.orb.n_features)
    tracker = tracker_cls(cfg, frontend, slam_map)
    tracker.local_mapper = mapper_cls(cfg, frontend, slam_map)
    return tracker


def _train_vocabulary(slam_map):
    """tests/test_relocalization.py's vocabulary: k = 8, depth 3, from the
    first 400 valid descriptors of every keyframe."""
    from orbslam2_tpu.vocab import train

    descs, docs = [], []
    for kf in sorted(slam_map.kf_valid):
        f = slam_map.kf_frame[kf]
        d = f.desc[f.valid][:400]
        descs.append(np.ascontiguousarray(d).view(np.uint8))
        docs.append(np.full(len(d), kf))
    return train.train_vocabulary(np.concatenate(descs), k=8, depth=3, doc_ids=np.concatenate(docs))


def _relocalize(reloc_cls, frame_cls, tracker, vocab, frame_images, frame_id):
    """Index every keyframe of the tracker's map, then relocalize the view:
    (database candidates, relocalized Tcw or None, whether the last
    attempt was accepted)."""
    reloc = reloc_cls(tracker.config, tracker.frontend, tracker.map, vocab)
    for kf in sorted(tracker.map.kf_valid):
        reloc.add_keyframe(kf)
    frame = frame_cls(tracker.frontend.process(*frame_images), 99.0, frame_id)
    words, vec = reloc.compute_bow(frame.desc, frame.valid)
    cands = reloc.database.detect_relocalization_candidates(words, vec, tracker.map)
    ok = reloc.relocalize(frame)
    accepted = bool(reloc.trace[-1]["ok"] and reloc.trace[-1]["cands"][-1]["stage"] == "accepted") \
        if reloc.trace else False
    return list(cands), (np.asarray(frame.Tcw) if ok else None), accepted


def _world():
    from orbslam2_tpu_torch.datasets.synthetic import SyntheticWorld

    return SyntheticWorld(n_points=900, seed=11, baseline=0.2)


def _run_jax():
    """The JAX package's pair through frame 28, the vocabulary trained on its
    map (as numpy arrays), and its relocalization of frame 16's view."""
    from orbslam2_tpu import config as jax_config
    from orbslam2_tpu.slam.frontend import FrameHost as JaxFrameHost
    from orbslam2_tpu.slam.frontend import Frontend as JaxFrontend
    from orbslam2_tpu.slam.local_mapping import LocalMapper as JaxMapper
    from orbslam2_tpu.slam.map import SlamMap as JaxMap
    from orbslam2_tpu.slam.relocalization import Relocalizer as JaxRelocalizer
    from orbslam2_tpu.slam.tracking import Tracker as JaxTracker

    world = _world()
    _, frames = world.render_sequence(N_PARITY, step=0.06)
    jt = _pair(jax_config, JaxFrontend, JaxMap, JaxTracker, JaxMapper, world)
    jax_out = []
    for i, (imL, imR) in enumerate(frames):
        T = jt.track(imL, imR, i / 20.0)
        jax_out.append((jt.state.name, None if T is None else np.asarray(T), jt.map.n_keyframes()))
    voc = _train_vocabulary(jt.map)
    jax_reloc = _relocalize(JaxRelocalizer, JaxFrameHost, jt, voc, frames[KIDNAPPED], N_PARITY)
    voc_arrays = {name: np.asarray(getattr(voc, name))
                  for name in ("children_desc", "children_idx", "node_word", "word_weight")}
    voc_arrays.update(k=int(voc.k), depth=int(voc.depth))
    return dict(jax_out=jax_out, jax_reloc=jax_reloc, voc=voc_arrays)


def _map_copy(m):
    """The port map's state without its lock and database hook (which a
    copy does not share), deep-copied."""
    return copy.deepcopy({k: v for k, v in vars(m).items() if k not in ("lock", "on_keyframe_removed")})


def _run_port():
    """The port's pair over all 45 frames (a copy of its map after frame
    28), then 6 frames in localization mode."""
    from orbslam2_tpu_torch import config as torch_config
    from orbslam2_tpu_torch.slam.frontend import Frontend
    from orbslam2_tpu_torch.slam.local_mapping import LocalMapper
    from orbslam2_tpu_torch.slam.map import SlamMap
    from orbslam2_tpu_torch.slam.tracking import Tracker

    world = _world()
    poses_gt, frames = world.render_sequence(N_FRAMES + N_LOCALIZATION, step=0.06)
    tt = _pair(torch_config, Frontend, SlamMap, Tracker, LocalMapper, world, device="cpu")
    port_out, n_ba = [], []
    for i, (imL, imR) in enumerate(frames[:N_FRAMES]):
        T = tt.track(imL, imR, i / 20.0)
        port_out.append((tt.state.name, T, tt.map.n_keyframes()))
        n_ba.append(tt.local_mapper.n_local_ba)
        if i == N_PARITY - 1:
            map_at_parity = _map_copy(tt.map)
    m, lm = tt.map, tt.local_mapper
    mapping = dict(
        state=tt.state.name, n_processed=lm.n_processed, n_created=lm.n_created,
        multi_obs=sum(1 for p in m.pt_valid if len(m.pt_obs[p]) >= 2),
        # per keyframe: (covisibility neighbours, spanning-tree parent)
        covis={int(kf): (bool(m.covis.get(kf)), kf in m.parent) for kf in m.kf_valid},
    )
    # localization mode: mapping stopped, visual-odometry points
    n_kf, n_pts = m.n_keyframes(), len(m.pt_valid)
    tt.only_tracking = True
    lm.request_stop()
    loc_out = []
    for i in range(N_FRAMES, N_FRAMES + N_LOCALIZATION):
        T = tt.track(*frames[i], i / 20.0)
        loc_out.append((tt.state.name, T, len(tt.last_frame.temp_points), tt._can_fuse()))
    localization = dict(out=loc_out, n_kf=(n_kf, m.n_keyframes()), n_pts=(n_pts, len(m.pt_valid)))
    return dict(port_out=port_out, n_ba=n_ba, mapping=mapping, poses_gt=poses_gt[:N_FRAMES],
                poses_loc=poses_gt[N_FRAMES:], localization=localization, map_at_parity=map_at_parity,
                kidnapped=frames[KIDNAPPED])


def port_relocalization(jax_part, port_part):
    """The port's relocalization of frame 16's view on its map after frame
    28, with the JAX part's vocabulary: as `_relocalize`."""
    from orbslam2_tpu_torch import config as torch_config
    from orbslam2_tpu_torch import convert
    from orbslam2_tpu_torch.slam.frontend import FrameHost, Frontend
    from orbslam2_tpu_torch.slam.map import SlamMap
    from orbslam2_tpu_torch.slam.relocalization import Relocalizer

    cfg = slam_config(_world(), torch_config)
    m = SlamMap.__new__(SlamMap)
    m.__dict__.update(copy.deepcopy(port_part["map_at_parity"]))
    m.lock, m.on_keyframe_removed = threading.RLock(), None
    tracker = types.SimpleNamespace(config=cfg, frontend=Frontend(cfg, device="cpu"), map=m)
    voc = convert.vocabulary_to_torch(types.SimpleNamespace(**jax_part["voc"]), "cpu")
    return _relocalize(Relocalizer, FrameHost, tracker, voc, port_part["kidnapped"], N_PARITY)


_PARTS = {"jax": _run_jax, "port": _run_port}


def shared_part(tmp_path_factory, name: str) -> dict:
    """Part `name` ("jax" or "port") of the run, made by its first caller of
    this session and read by the others (`_torch_parity.shared_run`)."""
    return shared_run(tmp_path_factory, f"torch_local_mapping_{name}", _PARTS[name])