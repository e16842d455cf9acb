"""The port's vocabulary trainer and dense BoW scores against the JAX
package's, on the CPU.

Stated tolerances: the trained vocabulary's arrays are equal to the JAX
trainer's (the same seed, bit for bit); the dense vectors and the six
DBoW2 scores are within 1e-6 of the JAX package's, on the inputs of
tests/test_vocab.py's scoring tests (the same vocabulary, places and
norms): absolute for the scores of normalized vectors, relative for the
unnormalized dot product (~349 here, where one float32 step is 3e-5 and
the two packages sum in different orders). The DBoW2 text parser: a text
file of the trained vocabulary parses to the JAX package's native
parser's arrays bit for bit, and loads to the trained tables and to the
JAX package's loader's, through its native parser and its Python loop.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import np_of

from orbslam2_tpu.vocab import bow as jbow
from orbslam2_tpu.vocab import train as jtrain
from orbslam2_tpu_torch.vocab import bow
from orbslam2_tpu_torch.vocab import train

METHODS = ("l1", "l2", "chi_square", "kl", "bhattacharyya", "dot_product")


def _same_tables(voc, jvoc):
    assert (voc.k, voc.depth) == (jvoc.k, jvoc.depth)
    np.testing.assert_array_equal(np_of(voc.children_desc).view(np.uint32), np.asarray(jvoc.children_desc))
    for name in ("children_idx", "node_word", "word_weight"):
        np.testing.assert_array_equal(np_of(getattr(voc, name)), np.asarray(getattr(jvoc, name)), err_msg=name)


def test_trainer_equals_jax():
    """tests/test_system.py:26-30's corpus (2000 random descriptors, k 6,
    depth 3, 20 documents), as bytes and as uint32 words."""
    rng = np.random.default_rng(0)
    descs = rng.integers(0, 256, (2000, 32), dtype=np.uint8)
    kw = dict(k=6, depth=3, doc_ids=np.repeat(np.arange(20), 100))
    for d in (descs, descs.view(np.uint32)):
        _same_tables(train.train_vocabulary(d, device="cpu", **kw), jtrain.train_vocabulary(d, **kw))


@pytest.fixture(scope="module")
def vocabs():
    """tests/test_vocab.py's tiny_vocab, trained by both packages."""
    rng = np.random.default_rng(1)
    descs = rng.integers(0, 256, (3000, 32), dtype=np.uint8)
    kw = dict(k=6, depth=3, doc_ids=np.repeat(np.arange(30), 100))
    voc, jvoc = train.train_vocabulary(descs, device="cpu", **kw), jtrain.train_vocabulary(descs, **kw)
    _same_tables(voc, jvoc)
    return voc, jvoc, descs


def _vectors(vocabs, norm):
    """(port, JAX) dense vectors of tests/test_vocab.py's places: descs[:300],
    a copy of it, descs[1000:1300]."""
    voc, jvoc, descs = vocabs
    out = []
    for d in (descs[:300], descs[:300].copy(), descs[1000:1300]):
        words32 = np.ascontiguousarray(d).view(np.uint32).reshape(-1, 8)
        w = bow.transform_words(voc, torch.from_numpy(words32.view(np.int32).copy()),
                                torch.ones(len(d), dtype=torch.bool))
        jw = jbow.transform_words(jvoc, jnp.asarray(words32), jnp.ones(len(d), bool))
        np.testing.assert_array_equal(np_of(w), np.asarray(jw))
        out.append((bow.bow_vector(voc, w, norm=norm), jbow.bow_vector(jvoc, jw, norm=norm)))
    return out


def test_dense_scores_equal_jax(vocabs):
    assert bow.SCORING_NORM == jbow.SCORING_NORM
    for method in METHODS:
        vecs = _vectors(vocabs, bow.SCORING_NORM[method])
        for v, jv in vecs:
            np.testing.assert_allclose(np_of(v), np.asarray(jv), rtol=0, atol=1e-6)
        (va, jva), (vb, jvb), (vf, jvf) = vecs
        for (x, jx), (y, jy) in (((va, jva), (vb, jvb)), ((va, jva), (vf, jvf)), ((vf, jvf), (va, jva))):
            got, want = float(bow.score(x, y, method)), float(jbow.score(jx, jy, method))
            assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), (method, got, want)
        # the JAX suite's bars hold on the port's scores too
        if method == "kl":
            assert abs(float(bow.score(va, vb, method))) < 1e-5
            assert float(bow.score(va, va, method)) < float(bow.score(va, vf, method))
        else:
            assert float(bow.score(va, va, method)) > float(bow.score(va, vf, method))
            if method != "dot_product":
                assert abs(float(bow.score(va, vb, method)) - 1.0) < 1e-4, method


def test_bow_vector_ignores_invalid_words(vocabs):
    voc = vocabs[0]
    words = torch.tensor([-1, 0, 0, 3, -1], dtype=torch.int32)
    v = bow.bow_vector(voc, words, norm=None)
    w = voc.word_weight
    assert float(v[0]) == float(2 * w[0]) and float(v[3]) == float(w[3])
    assert int((v != 0).sum()) == 2
    assert float(bow.bow_vector(voc, torch.full((3,), -1, dtype=torch.int32)).abs().sum()) == 0.0


def _write_dbow2_text(path, voc):
    """`voc` in DBoW2's text format (TemplatedVocabulary.h:1382-1416), its
    nodes in id order, each weight with 9 significant digits (exact for
    float32)."""
    ci, cd = np_of(voc.children_idx), np_of(voc.children_desc).view(np.uint8).reshape(*voc.children_idx.shape, 32)
    nw, ww = np_of(voc.node_word), np_of(voc.word_weight)
    parent, desc = np.full(len(nw), -1), np.zeros((len(nw), 32), np.uint8)
    for node, row in enumerate(ci):
        for slot in np.nonzero(row >= 0)[0]:
            parent[row[slot]], desc[row[slot]] = node, cd[node, slot]
    lines = [f"{voc.k} {voc.depth} 0 0"]
    for node in range(1, len(nw)):
        w = ww[nw[node]] if nw[node] >= 0 else 0.0
        lines.append(f"{parent[node]} {int(nw[node] >= 0)} {' '.join(map(str, desc[node]))} {w:.9g}")
    path.write_text("\n".join(lines) + "\n")


def test_dbow2_text_parser_equals_native_and_python(vocabs, tmp_path, monkeypatch):
    """The port's one-pass numpy parser of a DBoW2 text file of the trained
    vocabulary: its arrays equal, dtype and bits, to the JAX package's
    native parser (native/src/vocab_parse.cc); the vocabulary it loads
    equal to the trained one and to the JAX package's loader through its
    native parser and through its Python loop."""
    from orbslam2_tpu import native

    voc = vocabs[0]
    path = tmp_path / "voc.txt"
    _write_dbow2_text(path, voc)
    got = bow.parse_dbow2_text(str(path))
    want = native.parse_vocabulary_text(str(path))
    assert want is not None and got[:2] == want[:2] == (voc.k, voc.depth)
    for a, b in zip(got[2:], want[2:]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    loaded = bow.load_dbow2_text(str(path), "cpu")
    for name in ("children_desc", "children_idx", "node_word", "word_weight"):
        assert torch.equal(getattr(loaded, name), getattr(voc, name)), name
    _same_tables(loaded, jbow.load_dbow2_text(str(path)))
    monkeypatch.setattr(native, "_lib", None)  # the JAX package's Python loop
    _same_tables(loaded, jbow.load_dbow2_text(str(path)))
