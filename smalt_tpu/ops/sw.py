"""Batched Smith-Waterman scoring on the device.

This is the device replacement for the reference's Farrar striped
SSE2 kernels (swsimd.c:443-660): full-matrix affine-gap local
alignment, score only, with the running maximum taken over the
diagonal H' = H[i-1,j-1] + W[i,j] values (exactly the quantity the
striped kernels track in vMax).  Scores are identical to the host C
kernel `sw_full` and to the reference's 8-bit -> 16-bit retry chain.

The scorers walk subject rows with a `lax.scan`, carrying (H, E,
running max) per candidate, the query on the minor axis.  The in-row F
dependency is solved with a prefix-max scan instead of the reference's
lazy-F loop:

    F[j] = max_{j'<j} (H0[j'] - gapopen - (j-1-j') * gapext)
         = cummax(H0[j'] + j'*ge)[j-1] - gapopen - (j-1)*ge

exact whenever gapopen >= gapext (true for the defaults 4 >= 3;
asserted).  cummax is a log-depth associative scan: O(log Q) vector
ops per subject row instead of sequential lazy-F passes.

Everything is int32: reads are short enough that no 8/16-bit
overflow-retry chain is needed.

`sw_scores` picks the scorer (full-matrix or banded, plain or
tracked) for every caller.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

NEG = -(1 << 28)
LONG_READ_Q = 512   # above this (with a known seed diagonal) windows
                    # score in a band: O(band*S) instead of O(Q*S)
                    # (rmap.c:888-896 analog)


def sw_scores(qcodes, subj, slens, matrix, gapopen_pos, gapext_pos,
              track=False, band_pad=None):
    """Batched SW scores of [B, Q] query codes against [B, S] subject
    windows (padding past `slens` is ignored).

    band_pad: the window's left backoff before the seed diagonal, for
    callers that placed the window on one (fast mode).  With it,
    queries longer than LONG_READ_Q score in a band around that
    diagonal (`sw_band_score_ref`), which equals the full score
    whenever the optimal alignment stays inside the band.  Without it
    the full matrix is scored at any length, as the exact modes need.

    track=True returns (scores, ti, tj): the row-major-first argmax
    cell of each candidate's DP (subject row ti, query column tj), the
    anchor of the host traceback contract.  Query padding (code 7,
    scoring 0) can tie the best value but never precede its first
    occurrence, so the argmax always lands on a real cell.
    """
    assert gapopen_pos >= gapext_pos, "prefix-scan F requires go >= ge"
    Q = qcodes.shape[1]
    if band_pad is not None and Q > LONG_READ_Q:
        return sw_band_score_ref(qcodes, subj, slens, matrix, gapopen_pos,
                                 gapext_pos, band_pad,
                                 band_width_for(Q, band_pad), track=track)
    return sw_score_ref(qcodes, subj, slens, matrix, gapopen_pos,
                        gapext_pos, track=track)


def band_width_for(Q: int, pad: int) -> int:
    """Band width for a long-read window: wide enough to absorb the
    window pad (diagonal placement slack) plus ~3% indel drift each
    way, rounded to a multiple of 128."""
    need = 2 * pad + 2 * max(32, Q // 32)
    return max(128, -(-need // 128) * 128)


def sw_band_score_ref(qcodes, subj, slens, matrix, gapopen_pos,
                      gapext_pos, pad: int, W: int, track=False):
    """Banded batched SW scores for LONG reads: cost O(W*S) instead of
    O(Q*S) (the device analogue of the reference's banded host pass,
    rmap.c:888-896).  Subject row i covers query columns
    [i - pad - W/2, i - pad + W/2): `pad` is the window's left backoff
    (window_pad), so the seed diagonal sits mid-band.  In band
    coordinates the diagonal predecessor stays at the same lane, the
    query-gap predecessor (E) shifts one lane left, and the subject-gap
    F is the usual in-row prefix max.  Scores equal the full matrix
    whenever the optimal alignment stays inside the band; otherwise
    they lower-bound it.

    track=True adds the row-major-first argmax cell in (subject row,
    QUERY column) coordinates: the host tail centres its narrow
    traceback band on the end diagonal tj - ti instead of covering the
    whole device band."""
    qcodes = jnp.asarray(qcodes, jnp.int32)
    subj = jnp.asarray(subj, jnp.int32)
    slens = jnp.asarray(slens, jnp.int32)
    matrix = jnp.asarray(matrix, jnp.int32)
    B, Q = qcodes.shape
    S = subj.shape[1]
    go = jnp.int32(gapopen_pos)
    ge = jnp.int32(gapext_pos)
    prepad = pad + W // 2
    tidx = jnp.arange(W, dtype=jnp.int32)

    def scan_row(carry, i):
        H, E, vmax, bi, bl = carry
        j = i - prepad + tidx                       # query cols [B-free]
        jc = jnp.clip(j, 0, Q - 1)
        qc = jnp.where((j >= 0) & (j < Q), qcodes[:, jc], 7)
        code = subj[:, i]
        Wrow = matrix[code[:, None], qc]
        T = H + Wrow
        E_in = jnp.pad(E[:, 1:], ((0, 0), (0, 1)), constant_values=NEG)
        H0 = jnp.maximum(jnp.maximum(T, E_in), 0)
        c = H0 + tidx[None, :] * ge
        cm = jax.lax.associative_scan(jnp.maximum, c, axis=1)
        cm_shift = jnp.pad(cm[:, :-1], ((0, 0), (1, 0)),
                           constant_values=NEG)
        F = cm_shift - go - (tidx[None, :] - 1) * ge
        Hn = jnp.maximum(H0, F)
        En = jnp.maximum(E_in - ge, Hn - go)
        keep = (i < slens)
        Hn = jnp.where(keep[:, None], Hn, H)
        En = jnp.where(keep[:, None], En, E)
        rowmax = jnp.max(T, axis=1)
        upd = keep & (rowmax > vmax)
        minlane = jnp.min(jnp.where(T == rowmax[:, None], tidx[None, :],
                                    1 << 28), axis=1)
        vmax = jnp.where(upd, rowmax, vmax)
        bi = jnp.where(upd, i, bi)
        bl = jnp.where(upd, minlane, bl)
        return (Hn, En, vmax, bi, bl), None

    H0 = jnp.zeros((B, W), jnp.int32)
    E0 = jnp.full((B, W), NEG, jnp.int32)
    z = jnp.zeros(B, jnp.int32)
    (H, E, vmax, bi, bl), _ = jax.lax.scan(
        scan_row, (H0, E0, z, z, z), jnp.arange(S))
    if track:
        return jnp.maximum(vmax, 0), bi, bi + bl - prepad
    return jnp.maximum(vmax, 0)


def sw_score_ref(qcodes, subj, slens, matrix, gapopen_pos, gapext_pos,
                 track=False):
    """Full-matrix batched SW scores (the recurrence of the module
    docstring).  track=True adds the row-major-first argmax cell, as
    `sw_scores` documents."""
    qcodes = jnp.asarray(qcodes, jnp.int32)
    subj = jnp.asarray(subj, jnp.int32)
    slens = jnp.asarray(slens, jnp.int32)
    matrix = jnp.asarray(matrix, jnp.int32)
    B, Q = qcodes.shape
    S = subj.shape[1]
    go = jnp.int32(gapopen_pos)
    ge = jnp.int32(gapext_pos)
    jidx = jnp.arange(Q, dtype=jnp.int32)
    Wprof = jnp.take(matrix, qcodes, axis=1)       # [8, B, Q]
    Wprof = jnp.moveaxis(Wprof, 1, 0)              # [B, 8, Q]

    def scan_row(carry, i):
        H, E, vmax, bi, bj = carry
        code = subj[:, i]                          # [B]
        Wrow = jnp.take_along_axis(
            Wprof, code[:, None, None], axis=1)[:, 0, :]   # [B, Q]
        Hdiag = jnp.pad(H[:, :-1], ((0, 0), (1, 0)))
        T = Hdiag + Wrow
        keep = (i < slens)
        rowmax = jnp.max(T, axis=1)
        upd = keep & (rowmax > vmax)
        minlane = jnp.min(jnp.where(T == rowmax[:, None], jidx[None, :],
                                    1 << 28), axis=1)
        vmax = jnp.where(upd, rowmax, vmax)
        bi = jnp.where(upd, i, bi)
        bj = jnp.where(upd, minlane, bj)
        H0 = jnp.maximum(jnp.maximum(T, E), 0)
        c = H0 + jidx[None, :] * ge
        cm = jax.lax.associative_scan(jnp.maximum, c, axis=1)
        cm_shift = jnp.pad(cm[:, :-1], ((0, 0), (1, 0)),
                           constant_values=NEG)
        F = cm_shift - go - (jidx[None, :] - 1) * ge
        Hn = jnp.maximum(H0, F)
        En = jnp.maximum(E - ge, Hn - go)
        Hn = jnp.where(keep[:, None], Hn, H)
        En = jnp.where(keep[:, None], En, E)
        return (Hn, En, vmax, bi, bj), None

    H0 = jnp.zeros((B, Q), jnp.int32)
    E0 = jnp.zeros((B, Q), jnp.int32)
    z = jnp.zeros(B, jnp.int32)
    (H, E, vmax, bi, bj), _ = jax.lax.scan(
        scan_row, (H0, E0, z, z, z), jnp.arange(S))
    if track:
        return jnp.maximum(vmax, 0), bi, bj
    return vmax
