"""Device pass-2 for the exact lane: the reference's banded TRACK DP
(alignSmiWatBand, alignment.c:788-1027) plus its traceback walk
(makeMetaFromTrack, alignment.c:628-784) as one batched device program.

Pass 2 (banded fill + traceback of the survivors) is otherwise host
work that --device-exact leaves behind its device front half.  Here
the device fills the quirky banded recurrence for EVERY speculative
pass-2 candidate of a block and walks the traceback on-device,
shipping only a compact per-row step record
(~2 bytes/row); the host decoder (mapcore.c mc_align_recursive_dev)
replays the walk against its own profile/subject to emit the identical
back codes and verifies the telescoped checksum against the score.
Any decode doubt re-runs that single candidate through the host DP,
so byte-parity never depends on the device.

Recurrence (host oracle: native/swdp.c sw_band_track + sw_cell,
semantics of alignment.c:788-1027):

    cell = max(diag, e, f, 0);  e/f decay by gap_ext while positive;
    iff diag STRICTLY beat e, f and 0 AND diag > gap_init, both gap
    states rise to >= diag - gap_init ("reseed");
    the running best records diag at strict wins with diag > gap_init
    (row-major first-strict argmax);
    dirm: 3 on strict wins, else (e >= f ? 1 : 2) when cell > 0.

Vectorization exactness notes (each pinned by tests/test_device_pass2
differentials against the C kernel):
  - the in-row f chain untangles with the same prefix-max trick as the
    standard recurrence: a reseed candidate that would have been
    suppressed because diag <= f_in is dominated by the chain that
    suppressed it whenever gapopen >= gapext (asserted), so
    F*(j) = max_{j'<j}((diag' - gapopen) - (j-1-j')*gapext) over cells
    with diag' > max(e', 0) and diag' > gapopen equals the observable f;
  - "decay while positive" may be replaced by indefinite decay: values
    <= 0 are unobservable in cell/won/reseed, and the dirm tie rule
    (e >= f) is only consulted when max(e, f) > 0;
  - the unskewed query-lane frame reproduces diag_carry exactly: the
    one-lane shift brings H[band_lo-1], which is 0 during the
    lead-pinned rows (never written) and the last slid-out value
    afterwards.

Walk records, one int16 per subject row i in [final_i, max_i]:
    (nins << 2) | typ     typ: 3 DIA, 1 COL, 2 clean stop,
                          0 SUSPECT stop (the host walk would read a
                          dpos-aliased cell one column right of the
                          band, alignment.c's layout arithmetic; the
                          decoder must fall back to the host DP).

Window descriptor wd[w] (int32 x 8):
    {gstart, slen, read_idx, is_rev, l_edge, r_edge, q_left, q_len}
with (l_edge, r_edge, q_left, q_len) the POST-initALIBAND values for
the main interval (s_left = 0, s_len = slen); a window with slen <= 0
is a dummy (invalid geometry or oversize: host path).
"""
from __future__ import annotations

import functools

import numpy as np

NEG = -(1 << 28)


# ---------------------------------------------------------------------
# banded fill + walk
# ---------------------------------------------------------------------

def swq_fill_walk_ref(qalpha, subj, par, matrix, go, ge):
    """Banded fill + walk, batched over windows.

    qalpha: [W, Qp] int32 query alpha codes (strand-resolved)
    subj:   [W, Sp] int32 subject alpha codes (pad rows masked by slen)
    par:    [W, 8]  int32 {l_edge, r_edge, q_left, q_len, slen,
            valid, s_left, 0} — (slen, s_left) are initALIBAND's
            (b_s_len, b_s_left); rows run i in [s_left, slen)
    Returns (best, mi, mj, rec[W, Sp] int32).
    """
    import jax
    import jax.numpy as jnp

    qalpha = jnp.asarray(qalpha, jnp.int32)
    subj = jnp.asarray(subj, jnp.int32)
    par = jnp.asarray(par, jnp.int32)
    matrix = jnp.asarray(matrix, jnp.int32)
    W, Qp = qalpha.shape
    Sp = subj.shape[1]
    go = jnp.int32(go)
    ge = jnp.int32(ge)
    le, re_, ql, qn, sn, vd, sl = (par[:, k] for k in range(7))
    start_lo = jnp.maximum(ql, le)                       # [W]
    lead = jnp.maximum(0, ql - le)
    lane = jnp.arange(Qp, dtype=jnp.int32)[None, :]      # [1, Qp]
    Wprof = jnp.moveaxis(jnp.take(matrix, qalpha, axis=1), 1, 0)  # [W,8,Qp]

    def fill_row(carry, i):
        H, E, best, bi, bj = carry
        t_rel = i - sl                                   # [W]
        band_lo = start_lo + jnp.maximum(0, t_rel - lead)
        band_hi = jnp.minimum(qn, re_ + 1 + t_rel)
        in_band = ((lane >= band_lo[:, None]) & (lane < band_hi[:, None])
                   & ((i >= sl) & (i < sn))[:, None]
                   & (vd != 0)[:, None])
        scol = subj[:, i]
        Wrow = jnp.take_along_axis(Wprof, scol[:, None, None],
                                   axis=1)[:, 0, :]      # [W, Qp]
        diag = jnp.pad(H[:, :-1], ((0, 0), (1, 0))) + Wrow
        E_used = E
        pre = in_band & (diag > 0) & (diag > E_used)
        g = jnp.where(pre & (diag > go), diag - go, NEG)
        c = g + lane * ge
        cm = jax.lax.associative_scan(jnp.maximum, c, axis=1)
        cm_shift = jnp.pad(cm[:, :-1], ((0, 0), (1, 0)),
                           constant_values=NEG)
        # g embeds -gapopen already: F*(j) = max(g' + j'*ge) - (j-1)*ge
        F_used = cm_shift - (lane - 1) * ge
        won = pre & (diag > F_used)
        cell = jnp.maximum(jnp.maximum(diag, E_used),
                           jnp.maximum(F_used, 0))
        Hn = jnp.where(in_band, cell, H)
        reseed = jnp.where(won & (diag > go), diag - go, NEG)
        En = jnp.where(in_band, jnp.maximum(E_used - ge, reseed), E_used)
        code = jnp.where(won, 3,
                         jnp.where(in_band & (cell > 0),
                                   jnp.where(E_used >= F_used, 1, 2), 0))
        elig = won & (diag > go)
        dv = jnp.where(elig, diag, NEG)
        rowmax = jnp.max(dv, axis=1)
        upd = rowmax > best
        minlane = jnp.min(jnp.where(elig & (dv == rowmax[:, None]),
                                    lane, 1 << 28), axis=1)
        best = jnp.where(upd, rowmax, best)
        bi = jnp.where(upd, i, bi)
        bj = jnp.where(upd, minlane, bj)
        return (Hn, En, best, bi, bj), code

    H0 = jnp.zeros((W, Qp), jnp.int32)
    E0 = jnp.zeros((W, Qp), jnp.int32)
    z = jnp.zeros(W, jnp.int32)
    (H, E, best, bi, bj), dirm = jax.lax.scan(
        fill_row, (H0, E0, z, z, z), jnp.arange(Sp, dtype=jnp.int32))
    # dirm: [Sp, W, Qp]

    def walk_row(carry, t):
        j, done = carry
        i = Sp - 1 - t
        code = dirm[i]                                    # [W, Qp]
        active = (~done) & (i <= bi) & (i >= sl)
        band_lo = start_lo + jnp.maximum(0, i - sl - lead)
        band_hi = jnp.minimum(qn, re_ + 1 + i - sl)
        mask2 = (code == 2) & (lane >= ql[:, None])
        stop_idx = jnp.where(~mask2, lane, -1)
        hi = jax.lax.associative_scan(jnp.maximum, stop_idx, axis=1)
        hi_at_j = jnp.sum(jnp.where(lane == j[:, None], hi, 0), axis=1)
        hi_at_j = jnp.maximum(hi_at_j, ql - 1)
        nins = jnp.maximum(j - hi_at_j, 0)
        j2 = j - nins
        code2 = jnp.sum(jnp.where(lane == j2[:, None], code, 0), axis=1)
        stop = (j2 < ql) | (code2 == 0)
        suspect = stop & (j2 >= ql) & ((j2 >= band_hi) | (j2 < band_lo))
        typ = jnp.where(suspect, 0, jnp.where(stop, 2, code2))
        rec_i = jnp.where(active, (nins << 2) | typ, 0)
        j_next = jnp.where(active & ~stop,
                           jnp.where(code2 == 3, j2 - 1, j2), j)
        done_next = done | (active & stop)
        return (j_next, done_next), (i, rec_i)

    (jf, done), (ridx, rvals) = jax.lax.scan(
        walk_row, (bj, jnp.zeros(W, bool)),
        jnp.arange(Sp, dtype=jnp.int32))
    # rvals rows are emitted for i = Sp-1 .. 0: flip then transpose
    rec = jnp.moveaxis(jnp.flip(rvals, axis=0), 0, 1)
    return jnp.maximum(best, 0), bi, bj, rec


# ---------------------------------------------------------------------
# jitted step: window prep (strand resolve + subject gather) + fill/walk
# ---------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def build_pass2_step(matrix_bytes: bytes, matrix_shape, go: int, ge: int):
    """step(ref_alpha, reads, qlens, wd, Sp) -> (best, mi, mj, rec).

    reads: [B, Qp] uint8 mangled codes; wd: [W, 12] int32
    {gstart, slen, read_idx, is_rev, l_edge, r_edge, q_left, q_len,
     s_left, win_len, 0, 0} — slen is initALIBAND's b_s_len, win_len
    the subject gather length (>= slen; <= 0 marks a dummy window).
    Cached per (matrix, penalties) like _dp1_step_fn.
    """
    import jax
    import jax.numpy as jnp
    from ..device import ensure_compile_cache

    ensure_compile_cache()
    matrix = np.frombuffer(matrix_bytes, np.int32).reshape(matrix_shape)

    def _pack(best, mi, mj, rec):
        """One fused int32 output [W, 3 + Sp/2]: lanes 0..2 carry
        (best, mi, mj), the rest the int16 rec planes bit-packed in
        pairs, so the host fetches one buffer per block."""
        import jax
        import jax.numpy as jnp
        W2, Sp2 = rec.shape
        head = jnp.stack([best, mi, mj], axis=1)
        tail = jax.lax.bitcast_convert_type(
            rec.astype(jnp.int16).reshape(W2, Sp2 // 2, 2), jnp.int32)
        return jnp.concatenate([head, tail], axis=1)

    @functools.partial(jax.jit, static_argnames=("Sp",))
    def step(ref_alpha, reads, qlens, wd, Sp):
        reads = reads.astype(jnp.int32)
        n, Qp = reads.shape
        j = jnp.arange(Qp, dtype=jnp.int32)[None, :]
        src = qlens[:, None] - 1 - j
        valid = src >= 0
        g = jnp.take_along_axis(reads, jnp.maximum(src, 0), axis=1)
        std = (g & 4) == 0
        # codec bytes carry flag bits above the 3-bit alpha code: the
        # complement trick then &7, exactly as exact_collate.py:582
        rcq = jnp.where(valid, jnp.where(std, g ^ 3, g) & 7, 7)
        reads = jnp.where(j < qlens[:, None], reads & 7, 7)
        gstart, slen, ridx, is_rev = (wd[:, 0], wd[:, 1], wd[:, 2],
                                      wd[:, 3])
        qalpha = jnp.where((is_rev == 1)[:, None], rcq[ridx], reads[ridx])
        wlen = wd[:, 9]
        offs = jnp.arange(Sp, dtype=jnp.int32)[None, :]
        gidx = jnp.clip(gstart[:, None] + offs, 0,
                        ref_alpha.shape[0] - 1)
        wins = jnp.where(offs >= wlen[:, None], 7,
                         ref_alpha[gidx].astype(jnp.int32))
        snm = jnp.where(wlen > 0, slen, -1)
        par = jnp.stack([wd[:, 4], wd[:, 5], wd[:, 6], wd[:, 7],
                         snm, (wlen > 0).astype(jnp.int32),
                         wd[:, 8], wd[:, 10]], axis=1)
        return _pack(*swq_fill_walk_ref(qalpha, wins, par, matrix,
                                        go, ge))

    return step


def unpack_pass2(flat, nw, Sp):
    """Host-side split of build_pass2_step's fused output."""
    flat = np.ascontiguousarray(flat[:nw])
    best = flat[:, 0].astype(np.int64)
    mi = flat[:, 1].astype(np.int64)
    mj = flat[:, 2].astype(np.int64)
    rec = np.ascontiguousarray(flat[:, 3:]).view(np.int16)
    return best, mi, mj, np.ascontiguousarray(rec.reshape(nw, Sp))
