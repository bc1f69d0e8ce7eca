"""Device SW scorers vs the exact host C kernels (swsimd semantics)."""
import numpy as np
import pytest

from smalt_tpu.seq import codec
from smalt_tpu.align import core as ali
from smalt_tpu.ops import sw
from smalt_tpu.ops.sw import sw_score_ref


@pytest.fixture(scope="module")
def setup():
    m, go, ge = ali.make_score_matrix()
    lam = ali.matrix_lambda(m)
    return m, go, ge, lam


def _host_score(q, s, setup):
    m, go, ge, lam = setup
    p = ali.ScoreProfile.from_read(codec.encode(q), m, go, ge, lam)
    return ali.sw_full_score(p, codec.encode(s))


def _rand_seqs(rng, n, qlen, slen, mut=0.05):
    cases = []
    for _ in range(n):
        q = rng.choice(list(b"ACGT"), qlen)
        s = np.concatenate([rng.choice(list(b"ACGT"), 7), q.copy(),
                            rng.choice(list(b"ACGT"), slen - qlen - 7)])
        muts = rng.random(len(s)) < mut
        s[muts] = rng.choice(list(b"ACGT"), int(muts.sum()))
        cases.append((bytes(q.tolist()), bytes(s.tolist())))
    return cases


def test_jnp_ref_matches_host(setup):
    m, go, ge, lam = setup
    rng = np.random.default_rng(11)
    cases = _rand_seqs(rng, 16, 100, 160)
    qc = np.stack([codec.alpha(codec.encode(q)) for q, s in cases]).astype(np.int32)
    sc = np.stack([codec.alpha(codec.encode(s)) for q, s in cases]).astype(np.int32)
    slens = np.full(len(cases), sc.shape[1], np.int32)
    got = np.asarray(sw_score_ref(qc, sc, slens, m, -go, -ge))
    want = np.array([_host_score(q, s, setup) for q, s in cases])
    assert np.array_equal(got, want)


@pytest.mark.parametrize("Q,band_pad,track,want", [
    (512, 16, False, "full"),
    (512, 16, True, "full"),
    (513, 16, False, "band"),
    (513, 16, True, "band"),
    (513, None, False, "full"),
    (513, None, True, "full"),
])
def test_scorer_selection(monkeypatch, Q, band_pad, track, want):
    """sw_scores is the one place that picks the scorer: banded only
    above LONG_READ_Q and only with a seed-diagonal pad (fast mode);
    the exact modes (no pad) get the full matrix at any length."""
    calls = []
    monkeypatch.setattr(sw, "sw_score_ref",
                        lambda *a, **k: calls.append(("full", a, k)))
    monkeypatch.setattr(sw, "sw_band_score_ref",
                        lambda *a, **k: calls.append(("band", a, k)))
    q = np.zeros((2, Q), np.int32)
    sw.sw_scores(q, q, np.full(2, Q, np.int32), np.zeros((8, 8)), 4, 3,
                 track=track, band_pad=band_pad)
    (kind, args, kw), = calls
    assert kind == want
    assert kw == {"track": track}
    if kind == "band":
        assert args[6:] == (band_pad, sw.band_width_for(Q, band_pad))


@pytest.mark.parametrize("Q", [100, 150])
def test_scores_match_host_with_padding(setup, Q):
    """Q=100 and 150 windows with slens < S (junk past slen) and
    queries padded with code 7 to the 128-multiple caps the device
    paths use: scores equal the host C kernel on the unpadded pair."""
    m, go, ge, lam = setup
    rng = np.random.default_rng(Q)
    S = 256
    Qp = -(-Q // 128) * 128
    cases = _rand_seqs(rng, 16, Q, Q + 40, mut=0.08)
    qc = np.full((len(cases), Qp), 7, np.int32)
    sc = np.zeros((len(cases), S), np.int32)
    slens = rng.integers(Q // 2, Q + 41, len(cases)).astype(np.int32)
    want = []
    for i, (q, s) in enumerate(cases):
        qc[i, :Q] = codec.alpha(codec.encode(q))
        sc[i] = rng.integers(0, 4, S)           # junk past slens
        sc[i, : len(s)] = codec.alpha(codec.encode(s))
        want.append(_host_score(q, s[: slens[i]], setup))
    got = np.asarray(sw.sw_scores(qc, sc, slens, m, -go, -ge))
    assert np.array_equal(got, np.array(want)), (got, want)


def test_tracked_anchor_matches_host(setup):
    """track=True: the score and the row-major-first argmax cell equal
    the host device-canonical DP's (native sw_dev_track), the anchor
    the fast tail's traceback starts from."""
    import ctypes
    from smalt_tpu.native import get_lib
    m, go, ge, lam = setup
    lib = get_lib()
    f = lib.sw_dev_track
    vp, ci = ctypes.c_void_p, ctypes.c_int
    f.restype = ci
    f.argtypes = [vp, ci, vp, ci, ci, ci, vp, vp, vp, vp, vp]
    rng = np.random.default_rng(29)
    Q, S, n = 128, 160, 24
    cases = _rand_seqs(rng, n, 100, 150, mut=0.1)
    qc = np.full((n, Q), 7, np.int32)
    sc = np.full((n, S), 7, np.int32)
    slens = np.zeros(n, np.int32)
    for i, (q, s) in enumerate(cases):
        qc[i, :100] = codec.alpha(codec.encode(q))
        sc[i, : len(s)] = codec.alpha(codec.encode(s))
        slens[i] = len(s)
    best, ti, tj = (np.asarray(x) for x in sw.sw_scores(
        qc, sc, slens, m, -go, -ge, track=True))
    mat = np.asarray(m, np.int32)
    for i in range(n):
        W = np.ascontiguousarray(mat[:, qc[i]], np.int32)
        subj = np.ascontiguousarray(sc[i, : slens[i]], np.uint8)
        dirm = np.zeros(slens[i] * Q, np.uint8)
        H = np.zeros(Q, np.int32)
        E = np.zeros(Q, np.int32)
        mi, mj = ctypes.c_int(0), ctypes.c_int(0)
        hb = f(W.ctypes.data, Q, subj.ctypes.data, int(slens[i]),
               -go, -ge, dirm.ctypes.data, ctypes.byref(mi),
               ctypes.byref(mj), H.ctypes.data, E.ctypes.data)
        assert (best[i], ti[i], tj[i]) == (hb, mi.value, mj.value), i


def test_padded_subject_rows_ignored(setup):
    m, go, ge, lam = setup
    q = b"ACGTACGTACGTACGTACGTACGTACGTACGT"
    s = b"TTTT" + q + b"GG"
    qc = codec.alpha(codec.encode(q)).astype(np.int32)[None]
    s_pad = codec.alpha(codec.encode(s + q)).astype(np.int32)[None]  # junk past slen
    slens = np.array([len(s)], np.int32)
    got = int(np.asarray(sw_score_ref(qc, s_pad, slens, m, -go, -ge))[0])
    assert got == _host_score(q, s, setup) == 32


def test_nonstd_bases_score_zero(setup):
    m, go, ge, lam = setup
    q = b"ACGTNACGTACGTACGTNNACGTACGTACGTA"
    s = b"CC" + q + b"AA"
    qc = codec.alpha(codec.encode(q)).astype(np.int32)[None]
    sc = codec.alpha(codec.encode(s)).astype(np.int32)[None]
    slens = np.array([len(s)], np.int32)
    got = int(np.asarray(sw_score_ref(qc, sc, slens, m, -go, -ge))[0])
    assert got == _host_score(q, s, setup)
