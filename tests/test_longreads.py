"""Long/noisy reads (454/PacBio regime — SURVEY §5 long-context axis):
wide DP bands and split handling on the exact host path, and the
device path's window/pad scaling with query length.
"""
import numpy as np
import pytest

from smalt_tpu.seq import codec
from smalt_tpu.seq.io import Read
from smalt_tpu.seq.refset import RefSet
from smalt_tpu.index.table import build_index
from smalt_tpu.parallel import mesh as M


def _mutate(rng, seq: str, sub=0.05, ind=0.01):
    out = []
    for ch in seq:
        r = rng.random()
        if r < ind / 2:
            continue                      # deletion
        if r < ind:
            out.append("ACGT"[int(rng.integers(0, 4))])  # insertion
        if rng.random() < sub:
            ch = "ACGT"[int(rng.integers(0, 4))]
        out.append(ch)
    return "".join(out)


@pytest.fixture(scope="module")
def long_setup():
    rng = np.random.default_rng(17)
    bases = np.array(list(b"ACGT"), np.uint8)
    L = 200_000
    g = rng.choice(bases, L).tobytes().decode()
    import tempfile, os
    fa = tempfile.NamedTemporaryFile("w", suffix=".fa", delete=False)
    fa.write(">lg\n")
    for i in range(0, L, 60):
        fa.write(g[i : i + 60] + "\n")
    fa.close()
    refset = RefSet.from_fasta(fa.name)
    os.unlink(fa.name)
    return rng, g, refset


def test_window_formulas_scale():
    assert M.window_len(100) == 128 and M.window_pad(100) == 14
    assert M.window_len(1000) >= 1128
    assert M.window_pad(1000) >= 60     # indel drift slack grows with Q


def test_device_path_long_reads(long_setup):
    rng, g, refset = long_setup
    idx = build_index(refset, 13, 4)
    di = M.DeviceIndex.build(refset, idx)
    from smalt_tpu.align import core as ali
    m, go, ge = ali.make_score_matrix()
    Q = 1000
    B = 8
    reads = np.full((B, Q), 7, np.int32)
    truth = []
    for i in range(B):
        st = int(rng.integers(0, len(g) - 2 * Q))
        s = _mutate(rng, g[st : st + Q], sub=0.05, ind=0.01)[:Q]
        if i % 2:
            s = s.translate(str.maketrans("ACGT", "TGCA"))[::-1]
        codes = codec.alpha(codec.encode(s.encode())).astype(np.int32)
        reads[i, : len(codes)] = codes
        truth.append(st)
    out = M.device_map_step(di, np.asarray(reads), m, -go, -ge)
    score = np.asarray(out["score"])
    start = np.asarray(out["start"])
    pad = M.window_pad(Q)
    # noisy long reads must be found: positive scores well above the
    # random background and windows at the true locus
    assert (score > Q // 2).all(), score
    near = np.abs(start - np.asarray(truth)) <= pad + 64
    assert near.sum() >= B - 1, (start, truth)


def test_exact_path_long_reads(long_setup):
    rng, g, refset = long_setup
    idx = build_index(refset, 13, 4)
    from smalt_tpu.map.engine import MapEngine, MapParams
    eng = MapEngine(refset, idx, MapParams())
    n_ok = 0
    for i in range(6):
        st = int(rng.integers(0, len(g) - 3000))
        s = _mutate(rng, g[st : st + 2000], sub=0.05, ind=0.01)
        if i % 2:
            s = s.translate(str.maketrans("ACGT", "TGCA"))[::-1]
        read = Read(name=f"L{i}", seq=codec.encode(s.encode()),
                    qual=b"I" * len(s))
        rs = eng.rmap_single(read)
        assert rs.sortr, f"long read {i} unmapped"
        r = rs.sortr[0]
        glob = int(refset.offsets[r.sidx]) + r.s_start - 1
        if abs(glob - st) <= 100:
            n_ok += 1
        # alignment must cover most of the read despite indels
        assert r.q_end - r.q_start + 1 >= 0.9 * len(s), (i, r)
    assert n_ok == 6
