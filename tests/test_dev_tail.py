"""Device-anchored fast tail: the argmax-tracking scorer and the
mc_dev_align host side (gapless shortcut + device-canonical DP).

The contract under test (ops/sw.py track mode, mapcore.c mc_dev_align):
  * sw_score_ref(track=True) reports the row-major-first argmax of
    T = Hdiag + W — the cell the device scorer reports;
  * given that cell and the score, mc_dev_align's gapless shortcut
    reproduces EXACTLY what its full DP (sw_dev_track + exact-cost
    walker) computes, whenever it fires;
  * the DP's best score always equals the device scorer's score.
"""
import numpy as np
import pytest

from smalt_tpu.ops.sw import sw_score_ref
from smalt_tpu.map.fastmode import FastTail
from smalt_tpu.seq import codec
from smalt_tpu.seq.refset import RefSet


@pytest.fixture(scope="module")
def tail(tmp_path_factory):
    rng = np.random.default_rng(7)
    genome = "".join(rng.choice(list("ACGT"), 5000))
    fa = tmp_path_factory.mktemp("devtail") / "g.fa"
    fa.write_text(">c1\n" + genome + "\n")
    return FastTail(RefSet.from_fasta(str(fa))), genome


def _mutate(rng, win_str, qlen, with_indel):
    slen = len(win_str)
    qs = int(rng.integers(0, slen - qlen + 1)) if slen > qlen else 0
    q = list(win_str[qs:qs + qlen])
    for j in np.flatnonzero(rng.random(qlen) < 0.04):
        q[j] = "ACGT"[int(rng.integers(4))]
    if with_indel and qlen > 10:
        at = int(rng.integers(5, qlen - 5))
        if rng.random() < 0.5:
            q = q[:at] + q[at + 1:] + ["A"]
        else:
            q = q[:at] + ["C"] + q[at:]
        q = q[:qlen]
    return "".join(q)


def test_shortcut_equals_full_dp(tail):
    """mc_dev_align with the device anchor == forced full DP, and both
    match the jnp-oracle score, over random reads incl. indels."""
    ft, genome = tail
    rng = np.random.default_rng(11)
    matrix = ft.matrix
    go, ge = -ft.gapopen, -ft.gapext
    Q, S = 128, 256
    n_short = n_dp = 0
    for trial in range(150):
        qlen = int(rng.integers(30, 120))
        slen = int(rng.integers(qlen, 200))
        pos = int(rng.integers(0, 5000 - slen))
        win_str = genome[pos:pos + slen]
        qstr = _mutate(rng, win_str, qlen, rng.random() < 0.3)
        is_rev = bool(rng.random() < 0.5)
        qcodes = codec.encode(qstr.encode())
        win_codes = np.frombuffer(codec.encode(win_str.encode()), np.uint8)
        qa = codec.alpha(np.frombuffer(qcodes, np.uint8))
        qa_p = np.full(Q, 7, np.uint8)
        qa_p[:qlen] = qa
        if is_rev:
            rc = qa_p[::-1].copy()
            std = (rc & 4) == 0
            dev_q = np.where(std, rc ^ 3, rc)
            shift = Q - qlen
        else:
            dev_q = qa_p
            shift = 0
        wa = np.full(S, 7, np.int32)
        wa[:slen] = (win_codes & 7).astype(np.int32)
        sc, ti, tj = sw_score_ref(dev_q[None, :].astype(np.int32),
                                  wa[None, :],
                                  np.asarray([slen], np.int32),
                                  matrix, go, ge, track=True)
        sc, ti, tj = int(sc[0]), int(ti[0]), int(tj[0]) - shift
        if sc < 18:
            continue
        qarr = np.frombuffer(qcodes, np.uint8)
        r1 = ft._dev_align(qarr, is_rev, win_codes, ti, tj, sc)
        r2 = ft._dev_align(qarr, is_rev, win_codes, -1, -1, 0)
        assert r1 is not None and r2 is not None, (trial, sc)
        assert r1 == r2, (trial, sc, ti, tj, r1, r2)
        assert r1[0] == sc, (trial, r1[0], sc)
        ops = {b >> 6 for b in r1[5]}
        if 1 in ops or 2 in ops:
            n_dp += 1
        else:
            n_short += 1
    # both paths must actually be exercised
    assert n_short > 20 and n_dp > 5, (n_short, n_dp)
