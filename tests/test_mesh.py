"""Multi-device SPMD mapping step on the virtual 8-device CPU mesh —
the analogue of the reference's thread-determinism test
(test/mthread_test.py): sharded and single-device runs must agree."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from smalt_tpu.seq import codec
from smalt_tpu.align import core as ali
from smalt_tpu.parallel.mesh import (DeviceIndex, ShardedDeviceIndex,
                                     device_map_step, make_sharded_step,
                                     make_index_sharded_step)


@pytest.fixture(scope="module")
def device_setup(indexed):
    refset, idx = indexed
    di = DeviceIndex.build(refset, idx)
    m, go, ge = ali.make_score_matrix()
    return refset, di, m, go, ge


def _read_batch(refset, rng, B, Q):
    """Slice B perfect reads out of the reference (half reverse)."""
    reads = np.zeros((B, Q), np.int32)
    starts = rng.integers(0, refset.total_len - Q, B)
    truth = []
    for i, st in enumerate(starts):
        seg = codec.alpha(refset.codes[st : st + Q]).astype(np.int32)
        if i % 2:
            seg = seg[::-1] ^ 3
        reads[i] = seg
        truth.append(int(st))
    return jnp.asarray(reads), truth


def test_device_step_finds_perfect_reads(device_setup):
    refset, di, m, go, ge = device_setup
    rng = np.random.default_rng(3)
    B, Q = 16, 100
    reads, truth = _read_batch(refset, rng, B, Q)
    out = device_map_step(di, reads, m, -go, -ge)
    score = np.asarray(out["score"])
    strand = np.asarray(out["strand"])
    assert (score == Q).all()          # perfect alignments found
    assert (strand == np.arange(B) % 2).all()


def test_sharded_step_matches_single_device(device_setup):
    refset, di, m, go, ge = device_setup
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    rng = np.random.default_rng(9)
    B, Q = 32, 100
    reads, _ = _read_batch(refset, rng, B, Q)

    single = device_map_step(di, reads, m, -go, -ge)

    mesh = Mesh(np.array(devs[:8]).reshape(4, 2), ("dp", "ip"))
    step = make_sharded_step(di, mesh, m, -go, -ge)
    with mesh:
        sharded = step(reads)

    for k in ("score", "score2", "start", "strand"):
        assert np.array_equal(np.asarray(single[k]), np.asarray(sharded[k])), k


def test_index_sharded_step(device_setup):
    """REAL range-sharded index: each ip member holds only its slice of
    the reference + positions; every perfect read must still be found,
    including reads straddling the shard boundary, with window starts
    in global coordinates."""
    refset, di, m, go, ge = device_setup
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    from smalt_tpu.index.table import build_index
    idx = build_index(refset, 13, 4)
    sdi = ShardedDeviceIndex.build(refset, idx, n_shards=2, halo=640)

    rng = np.random.default_rng(21)
    B, Q = 32, 100
    reads = np.zeros((B, Q), np.int32)
    truth = np.zeros(B, np.int64)
    half = refset.total_len // 2
    for i in range(B):
        if i < 8:   # straddle the shard cut
            st = half - Q // 2 - i
        else:
            st = int(rng.integers(0, refset.total_len - Q))
        seg = codec.alpha(refset.codes[st : st + Q]).astype(np.int32)
        if i % 2:
            seg = seg[::-1] ^ 3
        reads[i] = seg
        truth[i] = st

    mesh = Mesh(np.array(devs[:8]).reshape(4, 2), ("dp", "ip"))
    step = make_index_sharded_step(sdi, mesh, m, -go, -ge)
    with mesh:
        out = step(jnp.asarray(reads))
    score = np.asarray(out["score"])
    start = np.asarray(out["start"])
    strand = np.asarray(out["strand"])
    assert (score == Q).all(), score
    assert (strand == np.arange(B) % 2).all()
    # window start is global and within the pad slack of the truth
    assert (np.abs(start - truth) <= 64).all(), (start, truth)


def test_repeat_ambiguity_detected(device_setup):
    """Reads from a duplicated segment must map with score2 == score —
    the device pass's ambiguity signal (downstream mapq -> 0)."""
    refset, di, m, go, ge = device_setup
    import tempfile, os
    from smalt_tpu.seq.refset import RefSet
    from smalt_tpu.index.table import build_index
    rng = np.random.default_rng(33)
    bases = np.array(list(b"ACGT"), np.uint8)
    seg = rng.choice(bases, 5000).tobytes().decode()
    filler1 = rng.choice(bases, 20000).tobytes().decode()
    filler2 = rng.choice(bases, 20000).tobytes().decode()
    g = filler1 + seg + filler2 + seg   # the 5 kb segment appears twice
    with tempfile.NamedTemporaryFile("w", suffix=".fa", delete=False) as fa:
        fa.write(">rep\n")
        for i in range(0, len(g), 60):
            fa.write(g[i : i + 60] + "\n")
        path = fa.name
    rs2 = RefSet.from_fasta(path)
    os.unlink(path)
    idx2 = build_index(rs2, 13, 4)
    di2 = DeviceIndex.build(rs2, idx2, direct=False)
    B, Q = 8, 100
    reads = np.zeros((B, Q), np.int32)
    for i in range(B):
        st = 20000 + 500 * i            # inside the first copy
        reads[i] = codec.alpha(rs2.codes[st : st + Q]).astype(np.int32)
    out = device_map_step(di2, jnp.asarray(reads), m, -go, -ge)
    score = np.asarray(out["score"])
    second = np.asarray(out["score2"])
    assert (score == Q).all()
    assert (second == Q).all(), (score, second)   # ambiguity visible


def test_dp_only_mesh(device_setup):
    refset, di, m, go, ge = device_setup
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    rng = np.random.default_rng(13)
    B, Q = 16, 100
    reads, _ = _read_batch(refset, rng, B, Q)
    mesh = Mesh(np.array(devs[:8]).reshape(8, 1), ("dp", "ip"))
    step = make_sharded_step(di, mesh, m, -go, -ge)
    with mesh:
        out = step(reads)
    assert (np.asarray(out["score"]) == Q).all()


def test_cross_shard_repeat_ambiguity(device_setup):
    """A repeat whose two copies land in DIFFERENT index shards: every
    shard sees a unique local best, but the combined runner-up must be
    the other shard's best (score2 == score => downstream mapq 0)."""
    refset, di, m, go, ge = device_setup
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    import tempfile, os
    from smalt_tpu.seq.refset import RefSet
    from smalt_tpu.index.table import build_index
    rng = np.random.default_rng(44)
    bases = np.array(list(b"ACGT"), np.uint8)
    seg = rng.choice(bases, 4000).tobytes().decode()
    fill1 = rng.choice(bases, 8000).tobytes().decode()
    fill2 = rng.choice(bases, 16000).tobytes().decode()
    fill3 = rng.choice(bases, 8000).tobytes().decode()
    # copy 1 in the lower half, copy 2 in the upper half of the genome
    g = fill1 + seg + fill2 + seg + fill3
    with tempfile.NamedTemporaryFile("w", suffix=".fa", delete=False) as fa:
        fa.write(">xrep\n")
        for i in range(0, len(g), 60):
            fa.write(g[i : i + 60] + "\n")
        path = fa.name
    rs2 = RefSet.from_fasta(path)
    os.unlink(path)
    idx2 = build_index(rs2, 13, 4)
    sdi = ShardedDeviceIndex.build(rs2, idx2, n_shards=2, halo=640)
    # the cut is at total_len/2 = 20000: copy 1 at [8000,12000) is in
    # shard 0, copy 2 at [28000,32000) in shard 1
    B, Q = 8, 100
    reads = np.zeros((B, Q), np.int32)
    for i in range(B):
        st = 8000 + 400 * i
        reads[i] = codec.alpha(rs2.codes[st : st + Q]).astype(np.int32)
    mesh = Mesh(np.array(devs[:8]).reshape(4, 2), ("dp", "ip"))
    step = make_index_sharded_step(sdi, mesh, m, -go, -ge)
    with mesh:
        out = step(jnp.asarray(reads))
    score = np.asarray(out["score"])
    second = np.asarray(out["score2"])
    start = np.asarray(out["start"])
    start2 = np.asarray(out["start2"])
    assert (score == Q).all()
    assert (second == Q).all(), (score, second)
    # the two placements are in different shards ~20000 apart
    assert (np.abs(start - start2) > 10000).all(), (start, start2)
