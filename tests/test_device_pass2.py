"""Device pass-2 differentials: the banded track fill + walk
(parallel/exact_pass2.py) against the host C kernel pair
sw_band_track + mc_traceback (native/swdp.c, native/mapcore.c) —
scores, argmax cells, and the decoded back-code stream must agree on
every non-suspect case; suspect stops (the dpos-alias hazard) may only
ever cause a fallback, never a silent difference.
"""
import ctypes

import numpy as np
import pytest

from smalt_tpu.align.core import AliBand, BandError
from smalt_tpu.native import get_lib

DIFFCOD_M, DIFFCOD_D, DIFFCOD_I, DIFFCOD_S = 0, 1, 2, 3
MAXMISMATCH = 61


def host_track(W8, qlen, subj, band, gi, ge):
    """sw_band_track via ctypes: (sc, mi, mj, dirm)."""
    lib = get_lib()
    nrows = band.s_len - band.s_left
    ndir = max(band.band_width * nrows, 1)
    dirm = np.zeros(ndir, np.uint8)
    H = np.zeros(qlen + 2, np.int32)
    E = np.zeros(qlen + 2, np.int32)
    mi = ctypes.c_int(0)
    mj = ctypes.c_int(0)
    Wc = np.ascontiguousarray(W8, np.int32)
    sc = lib.sw_band_track(
        Wc.ctypes.data, qlen, subj.ctypes.data,
        band.l_edge, band.r_edge, band.q_left, band.q_len,
        band.s_left, band.s_len, gi, ge, band.band_width,
        dirm.ctypes.data, ctypes.byref(mi), ctypes.byref(mj),
        H.ctypes.data, E.ctypes.data)
    return sc, mi.value, mj.value, dirm


def host_walk(W8, qlen, subj, band, mi, mj, sc, dirm, gi, ge):
    """mc_traceback via ctypes: (back bytes, out6) or None."""
    lib = get_lib()
    cap = 2 * (qlen + len(subj)) + 8
    back = np.zeros(cap, np.uint8)
    out6 = np.zeros(6, np.int64)
    cnt = np.zeros(8, np.int64)
    Wc = np.ascontiguousarray(W8, np.int32)
    rc = lib.mc_traceback(
        Wc.ctypes.data, qlen, subj.ctypes.data,
        band.s_left, band.q_left, band.l_edge, band.band_width,
        mi, mj, sc, dirm.ctypes.data, gi, ge, 0,
        back.ctypes.data, cap, out6.ctypes.data, cnt.ctypes.data)
    if rc != 0:
        return None
    return back[: out6[0]].tolist(), tuple(int(v) for v in out6[1:5])


def decode_rec(W8, subj, s_left, q_left, mi, mj, best, rec, gi, ge):
    """The device-record decoder (blueprint for mapcore.c
    mc_align_recursive_dev): returns (back, (ps, pe, ss, se)) or None
    on suspect/cap/checksum — None means host fallback."""
    i, j = int(mi), int(mj)
    checksum, nmatch = 0, 0
    back = []
    gap_open = False
    while i >= s_left and j >= q_left:
        v = int(rec[i])
        typ = v & 3
        nins = v >> 2
        if j - nins < q_left - 1:
            return None
        for _ in range(nins):
            checksum -= ge if gap_open else gi
            gap_open = True
            back.append((DIFFCOD_I << 6) | nmatch)
            nmatch = 0
            j -= 1
        if typ == 0:
            return None                      # suspect stop
        if typ == 2:
            break                            # clean stop
        if typ == 3:
            s = int(W8[subj[i] & 7, j])
            if s > 0:
                if nmatch > MAXMISMATCH:
                    back.append((DIFFCOD_M << 6) | MAXMISMATCH)
                    nmatch -= MAXMISMATCH
                else:
                    nmatch += 1
            else:
                back.append((DIFFCOD_S << 6) | nmatch)
                nmatch = 0
            checksum += s
            gap_open = False
            i -= 1
            j -= 1
        elif typ == 1:
            checksum -= ge if gap_open else gi
            gap_open = True
            back.append((DIFFCOD_D << 6) | nmatch)
            nmatch = 0
            i -= 1
        else:
            return None
    back.append((DIFFCOD_S << 6) | nmatch)
    back.append(DIFFCOD_M << 6)
    if checksum != best:
        return None
    return back, (j + 1, int(mj), i + 1, int(mi))


def default_matrix():
    m = np.full((8, 8), -2, np.int32)
    for a in range(4):
        m[a, a] = 1
    m[:, 4:] = 0
    m[4:, :] = 0
    return m


def gen_case(rng, matrix, gi, ge):
    qlen = int(rng.integers(20, 120))
    qalpha = rng.integers(0, 4, qlen).astype(np.int32)
    if rng.random() < 0.2:
        qalpha[rng.integers(0, qlen)] = int(rng.integers(4, 8))
    pad_l = int(rng.integers(0, 24))
    pad_r = int(rng.integers(0, 24))
    # planted alignment with mutations and indels
    mid = []
    p = 0
    while p < qlen:
        r = rng.random()
        if r < 0.08:
            mid.append(int(rng.integers(0, 4)))       # mismatch-ish
            p += 1
        elif r < 0.12:
            p += 1                                     # deletion in subj
        elif r < 0.16:
            mid.append(int(rng.integers(0, 4)))        # insertion in subj
        else:
            mid.append(int(qalpha[p]) & 3)
            p += 1
    subj = np.concatenate([
        rng.integers(0, 4, pad_l), np.asarray(mid, np.int64),
        rng.integers(0, 4, pad_r)]).astype(np.uint8)
    slen = len(subj)
    if rng.random() < 0.3:
        cqs, cqe = 0, qlen - 1
    else:
        cqs = int(rng.integers(0, qlen // 3))
        cqe = int(rng.integers(2 * qlen // 3, qlen))
    bw = int(rng.integers(2, 40))
    bl = pad_l - int(rng.integers(0, bw))
    br = bl + bw
    W8 = matrix[:, qalpha]
    return qlen, qalpha, subj, slen, cqs, cqe, bl, br, W8


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_oracle_vs_host(seed):
    from smalt_tpu.parallel.exact_pass2 import swq_fill_walk_ref

    rng = np.random.default_rng(seed)
    matrix = default_matrix()
    gi, ge = 4, 3
    n_suspect = 0
    n_checked = 0
    cases = []
    host = []
    Qp, Sp = 128, 192
    for _ in range(120):
        qlen, qalpha, subj, slen, cqs, cqe, bl, br, W8 = \
            gen_case(rng, matrix, gi, ge)
        if slen > Sp or qlen > Qp:
            continue
        try:
            band = AliBand.make(bl, br, cqs, cqe, qlen, 0, slen - 1, slen)
        except BandError:
            continue
        sc, mi, mj, dirm = host_track(W8, qlen, subj, band, gi, ge)
        cases.append((qalpha, subj, band, W8, qlen))
        host.append((sc, mi, mj,
                     host_walk(W8, qlen, subj, band, mi, mj, sc, dirm,
                               gi, ge) if sc > 0 else None))
    # batch the oracle
    W = len(cases)
    qa = np.full((W, Qp), 7, np.int32)
    sj = np.full((W, Sp), 7, np.int32)
    par = np.zeros((W, 8), np.int32)
    for w, (qalpha, subj, band, W8, qlen) in enumerate(cases):
        qa[w, :qlen] = qalpha
        sj[w, : len(subj)] = subj
        par[w] = [band.l_edge, band.r_edge, band.q_left, band.q_len,
                  band.s_len, 1, band.s_left, 0]
    best, bi, bj, rec = (np.asarray(x) for x in swq_fill_walk_ref(
        qa, sj, par, matrix, gi, ge))
    for w, (qalpha, subj, band, W8, qlen) in enumerate(cases):
        sc, mi, mj, hw = host[w]
        assert int(best[w]) == sc, (w, int(best[w]), sc)
        if sc <= 0:
            continue
        assert (int(bi[w]), int(bj[w])) == (mi, mj), (w, bi[w], bj[w],
                                                      mi, mj)
        dec = decode_rec(W8, subj, band.s_left, band.q_left,
                         mi, mj, sc, rec[w], gi, ge)
        n_checked += 1
        if dec is None:
            n_suspect += 1
            continue
        assert hw is not None, w
        back_h, out4 = hw
        back_d, out4_d = dec
        assert back_d == back_h, (w, back_d, back_h)
        assert out4_d == out4, w
    assert n_checked > 40
    assert n_suspect <= n_checked // 10   # suspects must stay rare


def test_pass2_step_vs_host():
    """The jitted build_pass2_step (strand resolve + subject gather from
    the resident reference + fill/walk + packed output) against the
    host C track DP and walk, on both strands."""
    from smalt_tpu.parallel.exact_pass2 import (build_pass2_step,
                                                unpack_pass2)

    rng = np.random.default_rng(4)
    matrix = default_matrix()
    gi, ge = 4, 3
    Qp, Sp = 128, 192
    cases, reads, ref, wd = [], [], [], []
    gstart = 0
    while len(cases) < 64:
        qlen, qalpha, subj, slen, cqs, cqe, bl, br, W8 = \
            gen_case(rng, matrix, gi, ge)
        if slen > Sp or qlen > Qp:
            continue
        try:
            band = AliBand.make(bl, br, cqs, cqe, qlen, 0, slen - 1, slen)
        except BandError:
            continue
        k = len(cases)
        is_rev = k % 2
        read = qalpha
        if is_rev:             # the step revcomps it back to qalpha
            std = (qalpha & 4) == 0
            read = np.where(std, qalpha ^ 3, qalpha)[::-1]
        reads.append(read)
        ref.append(subj)
        wd.append([gstart, band.s_len, k, is_rev, band.l_edge,
                   band.r_edge, band.q_left, band.q_len, band.s_left,
                   slen, 0, 0])
        gstart += slen
        cases.append((qalpha, subj, band, W8, qlen))
    codes = np.full((len(cases), Qp), 7, np.uint8)
    qlens = np.zeros(len(cases), np.int32)
    for k, r in enumerate(reads):
        codes[k, : len(r)] = r
        qlens[k] = len(r)
    ref_alpha = np.concatenate(ref).astype(np.uint8)
    step = build_pass2_step(matrix.tobytes(), matrix.shape, gi, ge)
    flat = step(ref_alpha, codes, qlens, np.asarray(wd, np.int32), Sp)
    best, bi, bj, rec = unpack_pass2(np.asarray(flat), len(cases), Sp)
    n_checked = n_suspect = 0
    for w, (qalpha, subj, band, W8, qlen) in enumerate(cases):
        sc, mi, mj, dirm = host_track(W8, qlen, subj, band, gi, ge)
        assert int(best[w]) == sc, (w, int(best[w]), sc)
        if sc <= 0:
            continue
        assert (int(bi[w]), int(bj[w])) == (mi, mj), w
        hw = host_walk(W8, qlen, subj, band, mi, mj, sc, dirm, gi, ge)
        dec = decode_rec(W8, subj, band.s_left, band.q_left, mi, mj, sc,
                         rec[w], gi, ge)
        n_checked += 1
        if dec is None:
            n_suspect += 1
            continue
        assert dec == hw, w
    assert n_checked >= 20
    assert n_suspect <= n_checked // 10


@pytest.mark.parametrize("seed", [5, 6])
def test_c_dev_align_vs_host(seed):
    """mc_align_recursive_dev with oracle records must match the plain
    host mc_align_recursive on every non-fallback case (results,
    diffstrs, and recursion sub-interval alignments)."""
    from smalt_tpu.parallel.exact_pass2 import swq_fill_walk_ref

    lib = get_lib()
    rng = np.random.default_rng(seed)
    matrix = default_matrix()
    gi, ge = 4, 3
    Qp, Sp = 128, 192
    cases = []
    for _ in range(80):
        qlen, qalpha, subj, slen, cqs, cqe, bl, br, W8 = \
            gen_case(rng, matrix, gi, ge)
        if slen > Sp or qlen > Qp:
            continue
        try:
            band = AliBand.make(bl, br, cqs, cqe, qlen, 0, slen - 1, slen)
        except BandError:
            continue
        cases.append((qalpha, subj, band, W8, qlen, (bl, br, cqs, cqe)))
    W = len(cases)
    qa = np.full((W, Qp), 7, np.int32)
    sj = np.full((W, Sp), 7, np.int32)
    par = np.zeros((W, 8), np.int32)
    for w, (qalpha, subj, band, W8, qlen, raw) in enumerate(cases):
        qa[w, :qlen] = qalpha
        sj[w, : len(subj)] = subj
        par[w] = [band.l_edge, band.r_edge, band.q_left, band.q_len,
                  band.s_len, 1, band.s_left, 0]
    best, bi, bj, rec = (np.asarray(x) for x in swq_fill_walk_ref(
        qa, sj, par, matrix, gi, ge))
    rec16 = np.ascontiguousarray(rec, np.int16)
    n_used = 0
    n_fb = 0
    for w, (qalpha, subj, band, W8, qlen, raw) in enumerate(cases):
        bl, br, cqs, cqe = raw
        slen = len(subj)
        minscore = max(8, int(best[w]) // 2) if best[w] > 0 else 8
        minscorlen = 8
        W8c = np.ascontiguousarray(W8, np.int32)
        H = np.zeros(qlen + 2, np.int32)
        E = np.zeros(qlen + 2, np.int32)
        ndir = (qlen + slen + 2) * (slen + 1)
        dirm = np.zeros(ndir, np.uint8)
        back = np.zeros(2 * (qlen + slen) + 8, np.uint8)
        res_cap = slen // 8 + 4

        def run(dev):
            pool = np.zeros(4096, np.uint8)
            res = np.zeros(res_cap * 7, np.int64)
            if dev:
                used = np.zeros(1, np.int64)
                n = lib.mc_align_recursive_dev(
                    W8c.ctypes.data, qlen, subj.ctypes.data, slen,
                    bl, br, cqs, cqe, 0, slen - 1,
                    minscore, minscorlen, gi, ge,
                    H.ctypes.data, E.ctypes.data,
                    dirm.ctypes.data, ndir,
                    back.ctypes.data, len(back),
                    pool.ctypes.data, len(pool),
                    res.ctypes.data, res_cap, 0, 1.0,
                    int(best[w]), int(bi[w]), int(bj[w]),
                    rec16[w].ctypes.data, Sp, used.ctypes.data)
                return n, res, pool, int(used[0])
            n = lib.mc_align_recursive(
                W8c.ctypes.data, qlen, subj.ctypes.data, slen,
                bl, br, cqs, cqe, 0, slen - 1,
                minscore, minscorlen, gi, ge,
                H.ctypes.data, E.ctypes.data,
                dirm.ctypes.data, ndir,
                back.ctypes.data, len(back),
                pool.ctypes.data, len(pool),
                res.ctypes.data, res_cap, 0, 1.0)
            return n, res, pool, 1

        nh, res_h, pool_h, _ = run(dev=False)
        nd, res_d, pool_d, used = run(dev=True)
        if not used:
            n_fb += 1
            continue
        n_used += 1
        assert nd == nh, (w, nd, nh)
        if nh > 0:
            np.testing.assert_array_equal(res_d[: nh * 7], res_h[: nh * 7])
            dtot = int(sum(res_h[a * 7 + 6] for a in range(nh)))
            np.testing.assert_array_equal(pool_d[:dtot], pool_h[:dtot])
    assert n_used > 30
    assert n_fb <= n_used // 8
