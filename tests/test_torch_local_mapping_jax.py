"""The port's tracker with its local mapper against the JAX package's pair,
built as in tests/test_local_mapping.py (same world, seed 11, 1200
features), on the CPU, through frame 28; then relocalization on the map
of frame 28 in both packages. The port alone over all 45 frames and
localization mode are in tests/test_torch_local_mapping.py; both files
read one run of the port's sequence, and this one the JAX package's too
(tests/_torch_local_mapping_run.py: the JAX part first, which the other
file does not need, so the two parts are made side by side).

Stated tolerances: through frame 28, which runs the second local BA, the
same tracking state and keyframe count every frame and camera centres
within 1 cm (measured on this sequence: <= 0.23 mm over all 45 frames).

Relocalization: on the map of frame 28 each package gets a Relocalizer
with the same vocabulary (the JAX package's `vocab/train.py`, k = 8,
depth 3, as tests/test_relocalization.py trains it, carried across with
`convert.vocabulary_to_torch`) and every keyframe indexed; both
relocalize the kidnapped view of frame 16: the same database candidates,
camera centres within 1 cm of each other and within 0.1 m of the ground
truth.
"""

import numpy as np
import pytest
from _torch_local_mapping_run import KIDNAPPED, N_PARITY, center, port_relocalization, shared_part


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jax_part = shared_part(tmp_path_factory, "jax")
    port_part = shared_part(tmp_path_factory, "port")
    return dict(jax_out=jax_part["jax_out"], port_out=port_part["port_out"], n_ba=port_part["n_ba"],
                poses_gt=port_part["poses_gt"],
                reloc=(jax_part["jax_reloc"], port_relocalization(jax_part, port_part)))


def test_matches_jax_through_second_local_ba(runs):
    assert runs["n_ba"][N_PARITY - 1] >= 2
    for i, ((sj, Tj, kj), (st, Tt, kt)) in enumerate(zip(runs["jax_out"], runs["port_out"])):
        assert (sj, kj) == (st, kt), i
        assert (Tj is None) == (Tt is None), i
        if Tj is not None:
            assert np.linalg.norm(center(Tj) - center(Tt)) < 0.01, i


def test_relocalization_matches_jax(runs):
    (jc, jT, _), (tc, tT, accepted) = runs["reloc"]
    assert len(jc) > 0 and tc == jc
    assert jT is not None and tT is not None
    assert accepted
    assert np.linalg.norm(center(tT) - center(jT)) < 0.01
    gt = center(runs["poses_gt"][KIDNAPPED])
    assert np.linalg.norm(center(tT) - gt) < 0.1 and np.linalg.norm(center(jT) - gt) < 0.1
