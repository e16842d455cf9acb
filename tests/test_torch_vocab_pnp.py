"""The port's BoW vocabulary, keyframe database and EPnP RANSAC against the
JAX package's, on the CPU.

Stated tolerances:
  * `transform_words_nodes` (K4's plain version) and `bow_sparse`: exactly
    equal, on the generic vocabulary of `assets/vocab_generic.npz` carried
    across with `convert.vocabulary_to_torch` and on the K4 edge cases of
    `kernels/cases.py` (a hand-built ragged tree with ties, a k = 40 tree,
    N == 0);
  * `KeyFrameDatabase` candidates: the same list in the same order;
  * `epnp_solve` and `pnp_ransac_from_hypotheses` (float64) against the
    JAX package's float32 `epnp_solve` and `pnp_ransac` on the same
    hypotheses, with the PCA axes' sign fixed alike in both: R within
    1e-4 rad, t within 1e-4 relative, inlier masks equal except for
    points within 1e-6 of their gate (epnp_solve on 0.5 px of noise; the
    RANSAC on exact inlier observations, see the test for why); a
    degenerate candidate (3 valid points, collinear points, one repeated
    point) returns without raising, with 0 inliers where the JAX package
    has 0.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch
from _torch_parity import matcher_pair, rot_err

from orbslam2_tpu.ops import pnp as jax_pnp
from orbslam2_tpu.slam.map import SlamMap as JaxMap
from orbslam2_tpu.vocab import bow as jax_bow
from orbslam2_tpu.vocab.database import KeyFrameDatabase as JaxDatabase
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.kernels import cases
from orbslam2_tpu_torch.ops import pnp
from orbslam2_tpu_torch.slam.map import SlamMap
from orbslam2_tpu_torch.vocab import bow
from orbslam2_tpu_torch.vocab.database import KeyFrameDatabase

VOCAB = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets", "vocab_generic.npz")


def _words_nodes_both(jvoc, desc_u32, valid, level=None):
    jw, jn = jax.jit(lambda d, v: jax_bow.transform_words_nodes(jvoc, d, v, level))(
        jnp.asarray(desc_u32), jnp.asarray(valid))
    tw, tn = bow.transform_words_nodes(convert.vocabulary_to_torch(jvoc, "cpu"),
                                       torch.from_numpy(np.ascontiguousarray(desc_u32).view(np.int32).copy()),
                                       torch.from_numpy(valid.copy()), level)
    return (np.asarray(jw), np.asarray(jn)), (tw.numpy(), tn.numpy())


def test_transform_words_nodes_and_bow_exact():
    jvoc = jax_bow.load_npz(VOCAB)
    _, eyes = matcher_pair(n_features=1200)
    rng = np.random.default_rng(0)
    desc = np.concatenate([eyes[0]["desc"], eyes[1]["desc"],
                           rng.integers(0, 2**32, (200, 8), dtype=np.uint64).astype(np.uint32)])
    valid = np.concatenate([eyes[0]["valid"], eyes[1]["valid"], rng.uniform(size=200) < 0.8])
    (jw, jn), (tw, tn) = _words_nodes_both(jvoc, desc, valid)
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(tn, jn)
    assert (tw >= 0).sum() == valid.sum() and len(np.unique(tw)) > 300
    weight = np.asarray(jvoc.word_weight)
    jb, tb = jax_bow.bow_sparse(jw, weight), bow.bow_sparse(tw, weight)
    for a, b in zip(jb, tb):
        np.testing.assert_array_equal(b, a)
    assert bow.l1_score_sparse(tb, tb) == jax_bow.l1_score_sparse(jb, jb)
    # the K4 edge cases: ragged tree with ties at every FeatureVector level,
    # a tree wider than a warp, N == 0
    for name, voc, d, v, level in cases.k4_raw_cases():
        jv = jax_bow.Vocabulary(*(jnp.asarray(a) for a in voc[:4]), voc[4], voc[5])
        (jw, jn), (tw, tn) = _words_nodes_both(jv, d, v, level)
        np.testing.assert_array_equal(tw, jw, err_msg=name)
        np.testing.assert_array_equal(tn, jn, err_msg=name)


def _databases_and_maps(rng, n_kf=12, n_words=600):
    """Both databases filled with the same keyframes (overlapping word
    windows, random idf weights), and both maps with the same hand-filled
    covisibility graph."""
    weight = rng.uniform(0.5, 3.0, n_words).astype(np.float32)
    dbs = (JaxDatabase(n_words), KeyFrameDatabase(n_words))
    maps = (JaxMap(1200), SlamMap(1200))
    kf_words = {}
    for kf in range(n_kf):
        words = rng.integers(30 * kf, 30 * kf + 200, 500)
        words[rng.uniform(size=500) < 0.1] = -1
        kf_words[kf] = words
        for db in dbs:
            db.add(kf, words, bow.bow_sparse(words, weight))
    for m in maps:
        for kf in range(n_kf):
            m.kf_valid.add(kf)
            m.covis[kf] = {}
        for kf in range(n_kf):
            for nb in (kf - 2, kf - 1, kf + 1, kf + 3):
                if 0 <= nb < n_kf:
                    w = 15 + (7 * kf + 3 * nb) % 40
                    m.covis[kf][nb] = m.covis[nb][kf] = w
    return dbs, maps, kf_words, weight


def test_database_candidates_match_jax():
    rng = np.random.default_rng(1)
    (jdb, tdb), (jmap, tmap), kf_words, weight = _databases_and_maps(rng)
    for kf in (9, 4):
        jdb.erase(kf)
        tdb.erase(kf)
    n_nonempty = 0
    for q in range(12):
        lo = 25 * q + 10
        words = rng.integers(lo, lo + 220, 600)
        vec = bow.bow_sparse(words, weight)
        want = jdb.detect_relocalization_candidates(words, vec, jmap)
        assert tdb.detect_relocalization_candidates(words, vec, tmap) == want, q
        n_nonempty += len(want) > 0
    assert n_nonempty >= 10
    for kf in (0, 3, 6, 11):
        for min_score in (0.0, 0.05):
            assert (tdb.detect_loop_candidates(kf, min_score, tmap)
                    == jdb.detect_loop_candidates(kf, min_score, jmap)), (kf, min_score)


def test_readded_keyframe_counts_once():
    """The JAX class leaves a re-added keyframe's old postings in its
    store, so that keyframe's shared words count twice (also after an
    erase); the port's `add` replaces them."""
    rng = np.random.default_rng(2)
    (jdb, tdb), _, kf_words, weight = _databases_and_maps(rng, n_kf=4)
    q = kf_words[2]
    once = tdb._common_words(q, set())[2]
    assert once == jdb._common_words(q, set())[2] == len(np.unique(q[q >= 0]))
    for db in (jdb, tdb):
        db.add(2, kf_words[2], bow.bow_sparse(kf_words[2], weight))
    assert tdb._common_words(q, set())[2] == once
    assert jdb._common_words(q, set())[2] == 2 * once
    for db in (jdb, tdb):
        db.erase(1)
        db.add(1, kf_words[1], bow.bow_sparse(kf_words[1], weight))
    q1 = kf_words[1]
    assert tdb._common_words(q1, set())[1] == len(np.unique(q1[q1 >= 0]))
    assert jdb._common_words(q1, set())[1] == 2 * tdb._common_words(q1, set())[1]
    assert tdb._post_n == sum(len(w) for w in tdb.kf_words.values())


def _scene(rng, n, outliers=0.3, noise_px=0.5):
    """A camera looking at n points 3-8 m ahead: (pw, obs normalized, R,
    t), `noise_px` of noise at fx = 458, a share of gross outliers."""
    a = rng.normal(0, 0.2, 3)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    R = np.linalg.qr(np.eye(3) + K)[0]
    R = R * np.sign(np.diag(R))[None, :]
    t = rng.normal(0, 0.3, 3)
    pc = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(3, 8, n)], 1)
    pw = (pc - t) @ R
    obs = pc[:, :2] / pc[:, 2:] + rng.normal(0, noise_px / 458, (n, 2))
    bad = rng.uniform(size=n) < outliers
    obs[bad] += rng.choice([-1, 1], (int(bad.sum()), 2)) * rng.uniform(0.02, 0.2, (int(bad.sum()), 2))
    return pw.astype(np.float32), obs.astype(np.float32), R, t


def _jax_hypotheses(key, valid, n_hyp=256):
    """pnp.py:210-212 of the JAX package: the Gumbel-top-4 draw."""
    logits = jnp.where(valid, 0.0, -1e9)
    g = jax.random.gumbel(key, (n_hyp, valid.shape[0])) + logits[None, :]
    return np.asarray(jax.lax.top_k(g, 4)[1])


def _canonical_eigh(eigh):
    """The JAX package's eigh with `pnp.canonical_axes`' sign rule on 3x3
    matrices (the PCA axes), which the port fixes and eigh leaves open."""
    def run(A):
        lam, V = eigh(A)
        if A.shape[-1] != 3:
            return lam, V
        top = jnp.argmax(jnp.abs(V), axis=-2, keepdims=True)
        return lam, V * jnp.where(jnp.take_along_axis(V, top, axis=-2) < 0, -1.0, 1.0)
    return run


def _ransac_both(rng, noise_px, n=300):
    """Three candidates of one frame (one scene; the others' map points
    moved by 2 mm where there is noise, 20% of them far off) and three
    degenerate ones (3 valid
    points; 40 collinear points; one point repeated), through one port call
    and the JAX package's pnp_ransac per candidate on the same hypotheses.
    Returns [(JAX result, port R, t, inliers, n_inliers, pw)], max_err2,
    obs, the scene's R."""
    sigma2 = 1.2 ** (2 * rng.integers(0, 8, n))
    max_err2 = (5.991 * sigma2 / (458.0 * 458.0)).astype(np.float32)
    pw0, obs, R, _ = _scene(rng, n, noise_px=noise_px)
    pws = [pw0]
    for _ in range(2):
        pw_c = pw0 + rng.normal(0, 0.002 * (noise_px > 0), pw0.shape).astype(np.float32)
        bad = rng.uniform(size=n) < 0.2
        pw_c[bad] += rng.normal(0, 0.5, (int(bad.sum()), 3)).astype(np.float32)
        pws.append(pw_c)
    valids = [rng.uniform(size=n) < p for p in (0.9, 0.6, 0.4)]
    line = pw0.copy()
    line[:40] = line[0] + np.linspace(0, 1, 40)[:, None] * np.array([0.3, 0.1, 0.5], np.float32)
    pws += [pw0, line, np.repeat(pw0[7:8], n, axis=0)]
    valids += [np.arange(n) < 3, np.arange(n) < 40, np.ones(n, bool)]
    keys = jax.random.split(jax.random.PRNGKey(42), len(pws))
    idx = np.stack([_jax_hypotheses(keys[c], jnp.asarray(v)) for c, v in enumerate(valids)])
    res = pnp.pnp_ransac_from_hypotheses(
        torch.from_numpy(idx), torch.from_numpy(np.stack(pws)), torch.from_numpy(obs),
        torch.from_numpy(np.stack(valids)), torch.from_numpy(max_err2))
    jransac = jax.jit(jax_pnp.pnp_ransac)
    out = [(jransac(keys[c], pws[c], obs, valids[c], max_err2), res.R[c].numpy(), res.t[c].numpy(),
            res.inliers[c].numpy(), int(res.n_inliers[c]), pws[c]) for c in range(len(pws))]
    return out, max_err2, obs, R


def test_epnp_and_ransac_match_jax(monkeypatch):
    """epnp_solve and the RANSAC, with the PCA axes' sign fixed in the JAX
    package's eigh as the port fixes it. A 4-point hypothesis's EPnP
    answer depends on the basis eigh picks for its 4-dimensional null
    space, which is set by rounding (float32 there, float64 here), so on
    noisy observations the two packages' hypotheses differ, and with them
    may the winner, or the fall-back to its raw pose. On exact inlier
    observations every good hypothesis finds the exact pose, and the two
    results agree to the stated tolerances; on 0.5 px of noise the inlier
    counts agree within 2 and both poses lie within 1e-2 rad of the truth.
    Degenerate candidates return without raising; where the JAX package
    finds 0 inliers the port does too, except that on one repeated 3D
    point its float64 solve may fit a pose through it (1 inlier) where the
    float32 one breaks down."""
    monkeypatch.setattr(jax_pnp.jnp.linalg, "eigh", _canonical_eigh(jnp.linalg.eigh))
    rng = np.random.default_rng(3)
    # epnp_solve on weighted noisy points (some weights 0)
    pw, obs, R, t = _scene(rng, 60, outliers=0.0)
    w = (rng.uniform(size=60) < 0.8).astype(np.float32)
    jR, jt, _ = jax.jit(jax_pnp.epnp_solve)(pw, obs, w)
    tR, tt, _ = pnp.epnp_solve(torch.from_numpy(pw), torch.from_numpy(obs), torch.from_numpy(w))
    tR, tt, jR, jt = tR.numpy(), tt.numpy(), np.asarray(jR), np.asarray(jt)
    assert rot_err(tR, jR) < 1e-4
    assert np.linalg.norm(tt - jt) < 1e-4 * np.linalg.norm(jt)
    assert rot_err(tR, R) < 1e-2

    for noise_px in (0.0, 0.5):
        out, max_err2, obs, R = _ransac_both(rng, noise_px)
        for c, (j, tR, tt, tinl, tn, pw_c) in enumerate(out):
            jn = int(j.n_inliers)
            if c == 5:  # one 3D point: a pose through it explains one observation
                assert jn > 0 or tn <= 1, (noise_px, c, tn)
                continue
            if c >= 3:  # degenerate: no raise, 0 where the JAX package has 0
                assert jn > 0 or tn == 0, (noise_px, c, tn)
                continue
            jR, jt, jinl = np.asarray(j.R), np.asarray(j.t), np.asarray(j.inliers)
            assert jn >= 40 and abs(tn - jn) <= 2, (noise_px, c, jn, tn)
            if noise_px > 0:
                assert rot_err(tR, R) < 1e-2 and rot_err(jR, R) < 1e-2, (c, rot_err(tR, R), rot_err(jR, R))
                continue
            assert rot_err(tR, jR) < 1e-4, (c, rot_err(tR, jR))
            assert np.linalg.norm(tt - jt) < 1e-4 * np.linalg.norm(jt), c
            # inlier masks equal except within 1e-6 of a point's gate
            pc = pw_c.astype(np.float64) @ tR.T + tt
            e2 = ((pc[:, :2] / pc[:, 2:] - obs) ** 2).sum(1)
            differ = tinl != jinl
            assert np.all(np.abs(e2[differ] - max_err2[differ]) < 1e-6), c
