"""Banded long-read device scorer: the skewed-band score must equal
the full-matrix score whenever the alignment stays inside the band —
verified on randomized gap grids vs the host C kernel — and cost
O(W*S) instead of O(Q*S)."""
import numpy as np
import pytest

from smalt_tpu.ops.sw import (sw_band_score_ref, sw_score_ref,
                              band_width_for)
from smalt_tpu.align import core as ali


def _host_full_score(qcodes, subj, matrix, go, ge):
    """Host C full-matrix oracle (sw_full via align core profile)."""
    from smalt_tpu.native import get_lib, GrowBuf
    lib = get_lib()
    if lib is None:
        pytest.skip("no native lib")
    q = np.asarray(qcodes, np.uint8)
    w = np.asarray(subj, np.uint8)
    qlen, slen = len(q), len(w)
    W = np.zeros((8, qlen), np.int32)
    for a in range(8):
        W[a] = matrix[a][q & 7]
    H = np.zeros(qlen + 1, np.int32)
    E = np.zeros(qlen + 1, np.int32)
    return lib.sw_full(W.ctypes.data, qlen, w.ctypes.data, slen,
                       go, ge, H.ctypes.data, E.ctypes.data)


@pytest.mark.parametrize("Q,pad", [(256, 32), (1024, 64)])
def test_banded_matches_full_on_gap_grids(Q, pad):
    rng = np.random.default_rng(Q)
    m, go, ge = ali.make_score_matrix()
    m = np.asarray(m, np.int32)
    B = 8
    W = band_width_for(Q, pad)
    S = Q + 2 * pad
    qs = np.zeros((B, Q), np.int32)
    ss = np.full((B, S), 7, np.int32)
    for b in range(B):
        ref = rng.integers(0, 4, S).astype(np.int32)
        # query copies the window at offset `pad` with mismatches and
        # small indels (drift well inside W/2)
        q = list(ref[pad : pad + Q])
        for j in rng.integers(0, Q, Q // 50):
            q[int(j)] = int(rng.integers(0, 4))
        ndel = int(rng.integers(0, 4))
        for _ in range(ndel):
            at = int(rng.integers(10, len(q) - 10))
            del q[at]
            q.append(int(rng.integers(0, 4)))
        qs[b] = np.asarray(q[:Q])
        ss[b] = ref
    slens = np.full(B, S, np.int32)
    banded = np.asarray(sw_band_score_ref(qs, ss, slens, m, -go, -ge,
                                          pad, W))
    for b in range(B):
        full = _host_full_score(qs[b], ss[b], m, -go, -ge)
        assert banded[b] == full, (b, banded[b], full)


def test_banded_is_lower_bound_outside_band():
    """An alignment displaced far beyond the band cannot be found, but
    the banded score never exceeds the full score."""
    rng = np.random.default_rng(3)
    m, go, ge = ali.make_score_matrix()
    m = np.asarray(m, np.int32)
    Q, pad = 256, 16
    W = 128
    S = 1024
    ref = rng.integers(0, 4, S).astype(np.int32)
    # query matches a region far right of the band diagonal
    q = ref[700 : 700 + Q].copy()
    qs = q[None, :]
    ss = ref[None, :]
    slens = np.asarray([S], np.int32)
    banded = int(np.asarray(sw_band_score_ref(qs, ss, slens, m, -go,
                                              -ge, pad, W))[0])
    full = int(np.asarray(sw_score_ref(qs, ss, slens, m, -go, -ge))[0])
    assert full == Q
    assert banded <= full


def test_banded_anchor_matches_full_ref():
    """track=True: the banded scorer's argmax anchor (subject row,
    query column) must land on the end cell of the planted alignment,
    and equal the full-matrix scorer's anchor when the alignment lies
    inside the band."""
    rng = np.random.default_rng(13)
    m, go, ge = ali.make_score_matrix()
    m = np.asarray(m, np.int32)
    Q, pad = 256, 32
    W = band_width_for(Q, pad)
    S = 384
    B = 4
    qs = rng.integers(0, 4, (B, Q)).astype(np.int32)
    ss = np.full((B, S), 7, np.int32)
    offs = [pad, pad + 3, pad - 5, pad + 11]   # shifted copies in band
    for b in range(B):
        ss[b, :S] = rng.integers(0, 4, S)
        ss[b, offs[b] : offs[b] + Q] = qs[b]
    slens = np.full(B, S, np.int32)
    sc, ti, tj = (np.asarray(x) for x in sw_band_score_ref(
        qs, ss, slens, m, -go, -ge, pad, W, track=True))
    assert (sc == Q).all()
    # exact copy: alignment ends at subject row offs[b]+Q-1, query Q-1
    for b in range(B):
        assert tj[b] == Q - 1, (b, tj)
        assert ti[b] == offs[b] + Q - 1, (b, ti, offs[b])
    # against the full-matrix tracker on the same input
    fsc, fti, ftj = (np.asarray(x) for x in sw_score_ref(
        qs, ss, slens, m, -go, -ge, track=True))
    assert (fsc == sc).all()
    assert (fti == ti).all() and (ftj == tj).all()
