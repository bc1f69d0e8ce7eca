"""The device scorers on the card, against the host C kernel and the
same call on the CPU, at the widths the mapping paths use.  Tolerance
is 0: every score is int32 and no matrix product is involved.

Marked `gpu`: skipped on the CPU, run on the card by chip_smoke.py."""
import numpy as np
import pytest

from smalt_tpu.align import core as ali
from smalt_tpu.ops.sw import band_width_for, sw_scores

pytestmark = pytest.mark.gpu

NWIN = 4096


def _windows(rng, n, Q, S, mut=0.05):
    """n (query, window) pairs: each window holds a mutated copy of its
    query with a few indels at a random offset; window lengths vary
    below S and the rest of each row is junk past slens."""
    q = rng.integers(0, 4, (n, Q)).astype(np.int32)
    s = rng.integers(0, 4, (n, S)).astype(np.int32)
    slens = rng.integers(Q, S + 1, n).astype(np.int32)
    for i in range(n):
        cp = list(q[i])
        for _ in range(int(rng.integers(0, 3))):
            at = int(rng.integers(1, Q - 1))
            if rng.random() < 0.5:
                del cp[at]
            else:
                cp.insert(at, int(rng.integers(0, 4)))
        cp = np.asarray(cp[: slens[i]], np.int32)
        cp = np.where(rng.random(len(cp)) < mut,
                      rng.integers(0, 4, len(cp)), cp)
        o = int(rng.integers(0, slens[i] - len(cp) + 1))
        s[i, o : o + len(cp)] = cp
    return q, s, slens


def _host_scores(q, s, slens, m, go, ge):
    from smalt_tpu.native import get_lib
    lib = get_lib()
    out = np.empty(len(q), np.int64)
    H = np.zeros(q.shape[1] + 1, np.int32)
    E = np.zeros(q.shape[1] + 1, np.int32)
    for i in range(len(q)):
        W = np.ascontiguousarray(m[:, q[i]], np.int32)
        w = np.ascontiguousarray(s[i, : slens[i]], np.uint8)
        out[i] = lib.sw_full(W.ctypes.data, q.shape[1], w.ctypes.data,
                             int(slens[i]), go, ge, H.ctypes.data,
                             E.ctypes.data)
    return out


def _on(device, fn, *arrays):
    import jax
    args = [jax.device_put(a, device) for a in arrays]
    out = jax.jit(fn)(*args)
    return [np.asarray(x) for x in (out if isinstance(out, tuple)
                                    else (out,))]


@pytest.fixture(scope="module")
def scoring():
    m, go, ge = ali.make_score_matrix()
    return np.asarray(m, np.int32), -go, -ge


@pytest.mark.parametrize("Q", [100, 150])
def test_card_scores_equal_host_c(scoring, Q):
    import jax
    m, go, ge = scoring
    q, s, slens = _windows(np.random.default_rng(Q), NWIN, Q, Q + 28)
    got, = _on(jax.devices()[0],
               lambda a, b, c: sw_scores(a, b, c, m, go, ge), q, s, slens)
    want = _host_scores(q, s, slens, m, go, ge)
    assert np.array_equal(got, want), np.flatnonzero(got != want)[:10]


def test_card_tracked_anchors_equal_cpu(scoring):
    import jax
    m, go, ge = scoring
    q, s, slens = _windows(np.random.default_rng(7), 3 * NWIN, 100, 128)

    def fn(a, b, c):
        return sw_scores(a, b, c, m, go, ge, track=True)

    card = _on(jax.devices()[0], fn, q, s, slens)
    cpu = _on(jax.devices("cpu")[0], fn, q, s, slens)
    for x, y in zip(card, cpu):
        assert np.array_equal(x, y)


def test_card_banded_q1500_equals_cpu(scoring):
    import jax
    from smalt_tpu.parallel.mesh import window_len, window_pad
    m, go, ge = scoring
    Q = 1500
    S, pad = window_len(Q), window_pad(Q)
    q, s, slens = _windows(np.random.default_rng(15), 256, Q, S,
                           mut=0.02)
    slens[:] = S

    def fn(a, b, c):
        return sw_scores(a, b, c, m, go, ge, track=True, band_pad=pad)

    card = _on(jax.devices()[0], fn, q, s, slens)
    cpu = _on(jax.devices("cpu")[0], fn, q, s, slens)
    assert band_width_for(Q, pad) < Q
    assert (card[0] > Q // 2).mean() > 0.5    # real alignments scored
    for x, y in zip(card, cpu):
        assert np.array_equal(x, y)
