"""Device-resident index and the SPMD mapping step.

The reference scales with a pthreads pipeline over shared memory
(threads.c:726-1014); the device equivalent is SPMD over a
`jax.sharding.Mesh`:

  * `dp` axis — read batches are data-parallel across chips
    (the analogue of the reference's N worker threads sharing a
    read-only index, smalt.c:1353-1391);
  * `ip` axis — the k-mer position list is sharded across chips for
    genomes too large for one HBM; every chip scans its shard of the
    diagonal space and the best candidates are combined with a max
    collective (the reference's seq-by-seq scan rmap.c:273-351,
    re-expressed as a reduction over shards).

`device_map_step` is the fully-jitted fast mapping step: k-mer word
extraction -> binary-search index lookup -> rarest-seed selection ->
diagonal-run voting -> windowed reference gather -> batched SW
scoring.  It returns, per read: best/second score, diagonal, strand.
This is the high-throughput first pass; the exact-parity traceback and
SAM emission run on host over the tiny set of survivors (the
reference's own two-pass structure, rmap.c:588-928).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..seq import codec
from ..index.table import KmerIndex
from ..seq.refset import RefSet
from ..ops.sw import LONG_READ_Q, sw_scores

from ..map.fastmode import LONG_READ_Q as _FT_LONG_READ_Q

assert LONG_READ_Q == _FT_LONG_READ_Q, \
    "scorer-selection boundary desync: fix map/fastmode.py AND the " \
    "512 literals in native/fastlane.c"

NSEED = 16        # rarest query k-mers expanded per strand
NSEED_COMMON = 4  # highest-count query k-mers expanded per strand: on a
                  # mutated repeat copy the rarest words are all
                  # copy-PRIVATE, so rarest-only seeding never votes for
                  # the other copies and the runner-up window (hence
                  # mapq) is wrong; the common pool recovers those
                  # placements (the fast-mode analogue of the reference
                  # collating every below-cutoff hit, hashhit.c)
MAXC = 6          # positions expanded per k-mer word
WIN_PAD = 16      # reference window padding around the seed diagonal


def window_len(Q: int) -> int:
    """Subject-window length for query length Q: the smallest 128-lane
    multiple with enough slack — the SW loop length scales kernel cost
    linearly and unaligned sizes lower poorly.  The slack absorbs
    diagonal quantization + indel drift, so it grows with Q (long
    noisy reads accumulate indels)."""
    slack = max(8, Q // 8)
    return max(128, -(-(Q + slack) // 128) * 128)


def window_pad(Q: int) -> int:
    """Left backoff of the gathered window before the seed diagonal."""
    return min((window_len(Q) - Q) // 2, max(2 * WIN_PAD, Q // 16))


@dataclass
class DeviceIndex:
    """Flat device arrays of a KmerIndex + packed reference codes.

    For word lengths with 2k <= DIRECT_BITS, `table` holds a
    direct-addressed offset table laid out as int32 [4^k, 2] pairs
    (table[w] = {starts[w], starts[w+1]}): a lookup is then ONE
    slice-2 HBM gather instead of a batched binary search — the
    searchsorted path sorts millions of (table ∪ query) keys per step
    and dominated the non-DP time, and gather op overhead (not
    bandwidth) dominates the table path, so one wide gather beats two
    narrow ones.  512 MB at k=13.

    For k = 16..20 (2k > 31: a packed word no longer fits int32 and
    jax has no x64 here) the word splits into a 12-base prefix `hi`
    (24 bits, direct-addressed: hi_table[hi] = bucket extent in the
    lexicographically sorted word list, 128 MB) and a (k-12)-base
    suffix `lo` (<= 16 bits, int32 array `words_lo`); a lookup is one
    hi gather plus `lo_steps` = ceil(log2(max bucket)) unrolled
    binary-search gathers — data-independent trip count, so XLA sees a
    static loop.  Covers the reference's full k range (menu.c:595,
    hashidx.c:155-158)."""
    wordlen: int
    nskip: int
    words: jnp.ndarray    # [W] int32 packed 2k-bit words (k <= 15)
    starts: jnp.ndarray   # [W+1] int32 CSR offsets
    pos: jnp.ndarray      # [Npos] int32 tuple serial numbers
    ref_alpha: jnp.ndarray  # [L] int32 3-bit reference codes (concatenated)
    ref_len: int
    table: Optional[jnp.ndarray] = None  # [4^k, 2] int32 offset pairs
    hi_table: Optional[jnp.ndarray] = None  # [4^12, 2] int32 bucket extents
    words_lo: Optional[jnp.ndarray] = None  # [W] int32 low suffix
    lo_steps: int = 0

    DIRECT_BITS = 28
    HI_BASES = 12

    @classmethod
    def build(cls, refset: RefSet, idx: KmerIndex,
              direct: Optional[bool] = None) -> "DeviceIndex":
        k = idx.wordlen
        if k > 20:
            raise ValueError("device path supports wordlen<=20 "
                             "(the reference's own max, menu.c:595)")
        table = hi_table = words_lo = None
        lo_steps = 0
        if 2 * k <= 31:
            if direct is None:
                direct = 2 * k <= cls.DIRECT_BITS
            if direct and 2 * k <= cls.DIRECT_BITS:
                nw = 1 << (2 * k)
                counts = np.zeros(nw + 1, np.int64)
                w = idx.words.astype(np.int64)
                counts[w + 1] = np.diff(idx.starts)
                t32 = np.cumsum(counts).astype(np.int32)
                pairs = np.stack([t32[:-1], t32[1:]], axis=1)  # [4^k, 2]
                table = jnp.asarray(np.ascontiguousarray(pairs))
            words32 = idx.words.astype(np.int64).astype(np.int32)
        else:
            lo_bits = 2 * (k - cls.HI_BASES)
            w = idx.words.astype(np.int64)       # sorted ascending
            hi = (w >> lo_bits).astype(np.int64)
            lo = (w & ((1 << lo_bits) - 1)).astype(np.int32)
            nhi = 1 << (2 * cls.HI_BASES)
            # bucket extents over the sorted word list
            bucket_start = np.searchsorted(hi, np.arange(nhi),
                                           side="left").astype(np.int32)
            bucket_end = np.searchsorted(hi, np.arange(nhi),
                                         side="right").astype(np.int32)
            hi_table = jnp.asarray(np.ascontiguousarray(
                np.stack([bucket_start, bucket_end], axis=1)))
            max_bucket = int((bucket_end.astype(np.int64) -
                              bucket_start).max()) if len(w) else 1
            lo_steps = max(1, int(np.ceil(np.log2(max(max_bucket, 1) + 1))))
            words_lo = jnp.asarray(lo)
            words32 = np.zeros(1, np.int32)      # unused in hi/lo mode
        return cls(
            wordlen=k,
            nskip=idx.nskip,
            words=jnp.asarray(words32),
            starts=jnp.asarray(idx.starts.astype(np.int32)),
            pos=jnp.asarray(idx.pos.astype(np.int32)),
            ref_alpha=jnp.asarray(codec.alpha(refset.codes).astype(np.int32)),
            ref_len=refset.total_len,
            table=table,
            hi_table=hi_table,
            words_lo=words_lo,
            lo_steps=lo_steps,
        )

    @classmethod
    def build_ref_only(cls, refset: RefSet, idx: KmerIndex
                       ) -> "DeviceIndex":
        """Reference codes only — the host_hits device-exact regime
        never reads the k-mer table on device (the host expands hit
        keys), so skip the table/pos residency (~300 MB at k = 13)
        and any word-length limit with it."""
        z = jnp.zeros(1, jnp.int32)
        return cls(
            wordlen=idx.wordlen,
            nskip=idx.nskip,
            words=z, starts=z, pos=z,
            ref_alpha=jnp.asarray(
                codec.alpha(refset.codes).astype(np.int32)),
            ref_len=refset.total_len,
        )


def _rev_groups2(x):
    """Reverse the sixteen 2-bit groups of an int32 lane-wise (4 masked
    butterfly steps)."""
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x & 0xFFFF) << 16) | ((x >> 16) & 0xFFFF)


def _query_words(reads, k):
    """Forward and reverse-complement k-mer words per query position.
    reads: [B, Q] int32 3-bit codes.  Returns (fwd, rc, valid): [B, P].

    Only the forward word accumulates over k steps; the RC word is its
    bitwise 2-bit-group reversal after complementing, and window
    validity comes from a prefix sum of bad-base flags."""
    B, Q = reads.shape
    P_ = Q - k + 1
    std = reads & 3
    fwd = jnp.zeros((B, P_), jnp.int32)
    for j in range(k):
        fwd = (fwd << 2) | std[:, j : j + P_]
    # mask after the shift: the reversed value can carry the sign bit
    # and int32 >> sign-extends
    rc = (_rev_groups2(fwd ^ ((1 << (2 * k)) - 1)) >> (2 * (16 - k))) \
        & ((1 << (2 * k)) - 1)
    bad = (reads & 4).astype(jnp.int32) >> 2
    cbad = jnp.cumsum(bad, axis=1)
    prev = jnp.pad(cbad[:, : Q - k], ((0, 0), (1, 0)))
    nbad = cbad[:, k - 1 :] - prev
    return fwd, rc, nbad == 0


def _pack_window(std, off, width, P_):
    """Pack `width` 2-bit codes starting at query offset `off` for all
    P_ window positions: [B, P_] int32, MSB-first."""
    acc = jnp.zeros(std.shape[:1] + (P_,), jnp.int32)
    for j in range(width):
        acc = (acc << 2) | std[:, off + j : off + j + P_]
    return acc


def _rev_groups_w(x, w):
    """Reverse the first w 2-bit groups of a packed value (width 2w)."""
    return (_rev_groups2(x) >> (2 * (16 - w))) & ((1 << (2 * w)) - 1)


def _query_words_hilo(reads, k):
    """Query words for k in 16..20 as (hi, lo) int32 pairs per strand:
    hi = first HI_BASES bases (24 bits), lo = the remaining k-12 bases.
    Returns (fwd_hi, fwd_lo, rc_hi, rc_lo, valid), each [B, P]."""
    HB = DeviceIndex.HI_BASES
    B, Q = reads.shape
    P_ = Q - k + 1
    wlo = k - HB
    std = reads & 3
    mask_lo = (1 << (2 * wlo)) - 1
    fwd_hi = _pack_window(std, 0, HB, P_)
    fwd_lo = _pack_window(std, HB, wlo, P_)
    # rc word of window [p, p+k): first 12 rc bases = revcomp of the
    # LAST 12 window bases; rc low suffix = revcomp of the FIRST k-12
    tail12 = _pack_window(std, k - HB, HB, P_)
    head_lo = _pack_window(std, 0, wlo, P_)
    rc_hi = _rev_groups_w(tail12 ^ ((1 << (2 * HB)) - 1), HB)
    rc_lo = _rev_groups_w(head_lo ^ mask_lo, wlo)
    bad = (reads & 4).astype(jnp.int32) >> 2
    cbad = jnp.cumsum(bad, axis=1)
    prev = jnp.pad(cbad[:, : Q - k], ((0, 0), (1, 0)))
    nbad = cbad[:, k - 1 :] - prev
    return fwd_hi, fwd_lo, rc_hi, rc_lo, nbad == 0


def _lookup_hilo(di: DeviceIndex, qhi, qlo, valid):
    """(counts, pos_base, hit) for the split-word index: one hi-table
    gather for the bucket extent, then `lo_steps` unrolled lower-bound
    gathers over the sorted low suffixes (static trip count)."""
    ext = di.hi_table[qhi]                   # [..., 2]
    lo_arr = di.words_lo
    n_lo = lo_arr.shape[0]
    lo_s = ext[..., 0]
    hi_s = ext[..., 1]
    end = ext[..., 1]
    for _ in range(di.lo_steps):
        active = lo_s < hi_s
        mid = (lo_s + hi_s) >> 1
        mv = lo_arr[jnp.clip(mid, 0, n_lo - 1)]
        go_right = active & (mv < qlo)
        lo_s = jnp.where(go_right, mid + 1, lo_s)
        hi_s = jnp.where(active & ~go_right, mid, hi_s)
    slot = jnp.clip(lo_s, 0, n_lo - 1)
    hit = valid & (lo_s < end) & (lo_arr[slot] == qlo)
    counts = jnp.where(hit, di.starts[slot + 1] - di.starts[slot], 0)
    base = di.starts[jnp.where(hit, slot, 0)]
    return counts, base, hit


def _lookup(di: DeviceIndex, qwords, valid):
    """Index lookup: (counts, pos_base, hit) with miss -> count 0.
    pos_base is the offset of the word's first position in di.pos.

    Direct-table path: two gathers from the cumulative-offset table.
    Fallback: batched binary search (method='sort' batches all queries
    through one sort instead of the default scan path's while_loop)."""
    if di.table is not None:
        pair = di.table[qwords]                  # [..., 2]: one gather
        s0 = pair[..., 0]
        s1 = pair[..., 1]
        counts = jnp.where(valid, s1 - s0, 0)
        hit = counts > 0
        return counts, s0, hit
    ix = jnp.searchsorted(di.words, qwords, method="sort").astype(jnp.int32)
    ixc = jnp.clip(ix, 0, di.words.shape[0] - 1)
    hit = (di.words[ixc] == qwords) & valid
    counts = jnp.where(hit, di.starts[ixc + 1] - di.starts[ixc], 0)
    base = di.starts[jnp.where(hit, ixc, 0)]
    return counts, base, hit


def _expand_hits(di: DeviceIndex, base, counts, qoffs, is_reverse):
    """Expand up to MAXC positions per selected seed into diagonal shifts
    (tuple units): forward  pos - qoffs//nskip,
                   reverse  pos + qoffs//nskip   (hashhit.h:67-72 packing).
    base: [B, NSEED] offsets of each word's first position in di.pos.
    Returns (shift, ok): [B, NSEED*MAXC]."""
    B = base.shape[0]
    offs = jnp.arange(MAXC, dtype=jnp.int32)
    pidx = base[:, :, None] + offs[None, None, :]
    pidx = jnp.clip(pidx, 0, di.pos.shape[0] - 1)
    pos = di.pos[pidx]                           # [B, NSEED, MAXC]
    ok = offs[None, None, :] < counts[:, :, None]
    qo = (qoffs // di.nskip)[:, :, None]
    shift = pos + qo if is_reverse else pos - qo
    shift = jnp.where(ok, shift, -(1 << 30))
    return shift.reshape(B, -1), ok.reshape(B, -1)


def _merge_sorted_asc(a, b):
    """Bitonic merge of two equal-width power-of-2 ascending rows:
    concat(a, reverse(b)) is bitonic; log2(2w) compare-exchange
    stages sort it, instead of re-sorting the concatenation."""
    B = a.shape[0]
    m = jnp.concatenate([a, b[:, ::-1]], axis=1)
    n = m.shape[1]
    d = n // 2
    while d >= 1:
        p = m.reshape(B, n // (2 * d), 2, d)
        lo = jnp.minimum(p[:, :, 0], p[:, :, 1])
        hi = jnp.maximum(p[:, :, 0], p[:, :, 1])
        m = jnp.stack([lo, hi], axis=2).reshape(B, n)
        d //= 2
    return m


def _best_diagonal(shift, ok, tol, presorted=False):
    """Densest diagonal run per read: sort shifts, count how many of the
    following NSEED*MAXC-window fall within `tol`, pick the argmax.
    Returns (best_shift, votes, second_shift, second_votes, n2nd_est):
    n2nd_est counts the DISTINCT far diagonal clusters that tie the
    runner-up's vote count — on a multi-copy repeat every unscored copy
    is a plausible runner-up, and the mapq qn term needs their number
    (results.c n_swatscor_2nd), not just the one window we score.

    presorted: `shift` is already ascending (invalid -2^30 first)."""
    B, N = shift.shape
    s = shift if presorted else jnp.sort(shift, axis=1)
    votes = jnp.zeros((B, N), jnp.int32)
    for d in range(1, min(N, 16)):
        nb = jnp.concatenate(
            [s[:, d:], jnp.full((B, d), 1 << 30, jnp.int32)], axis=1)
        votes = votes + ((nb - s) <= tol).astype(jnp.int32)
    valid = s > -(1 << 29)
    votes = jnp.where(valid, votes + 1, 0)
    b1 = jnp.argmax(votes, axis=1)
    best = jnp.take_along_axis(s, b1[:, None], 1)[:, 0]
    v1 = jnp.take_along_axis(votes, b1[:, None], 1)[:, 0]
    far = jnp.abs(s - best[:, None]) > 2 * tol
    votes2 = jnp.where(far, votes, 0)
    b2 = jnp.argmax(votes2, axis=1)
    second = jnp.take_along_axis(s, b2[:, None], 1)[:, 0]
    v2 = jnp.take_along_axis(votes2, b2[:, None], 1)[:, 0]
    # cluster starts: first sorted entry, or a jump > tol from the left
    # neighbour; a start's vote count covers its whole cluster
    starts_ = jnp.concatenate(
        [valid[:, :1], (s[:, 1:] - s[:, :-1] > tol) & valid[:, 1:]], axis=1)
    n2nd = jnp.sum((starts_ & far & (votes == v2[:, None]) &
                    (v2[:, None] > 0)).astype(jnp.int32), axis=1)
    return best, v1, second, v2, jnp.maximum(n2nd, 1)


def _gather_windows(di: DeviceIndex, shifts, S, origin_off):
    """Reference windows [B, S] starting at shift*nskip + origin_off.
    di.ref_len may be a traced scalar (sharded local lengths)."""
    start = shifts * di.nskip + origin_off
    start = jnp.clip(start, 0, jnp.maximum(di.ref_len - S, 0))
    offs = jnp.arange(S, dtype=jnp.int32)
    gidx = start[:, None] + offs[None, :]
    gidx = jnp.clip(gidx, 0, di.ref_len - 1)
    win = di.ref_alpha[gidx]
    # mask rows past the reference end with TERM-like code 7 (scores 0)
    return win, start


def device_seed_votes(di: DeviceIndex, reads):
    """Seeding + diagonal voting half of the fast mapping step: query
    words, index lookups, rarest+common seed selection, hit expansion
    and densest-diagonal voting per strand.  Returns
    (outs, hits_used, hits_tot) with outs = [(b1, v1, b2, v2, nc2)
    for fwd, rev] — shift diagonals in this index's (possibly
    shard-local) tuple serials."""
    reads = reads.astype(jnp.int32)
    B, Q = reads.shape
    k = di.wordlen
    hilo = di.words_lo is not None
    if hilo:
        fh, fl, rh, rl, valid = _query_words_hilo(reads, k)
        fwd = jnp.stack([fh, fl])        # [2, B, P]
        rc = jnp.stack([rh, rl])
    else:
        fwd, rc, valid = _query_words(reads, k)
    # query-side seed sampling: table gathers dominate the seeding
    # cost, so skip query positions when there are plenty — but the
    # stride MUST be coprime with the index stride (nskip), otherwise
    # only alignments in matching phase keep any sampled seeds at all.
    # keep >= ~12 phase-matching positions: P/stride/nskip >= 12
    import math as _math
    stride = 0
    for c in (2, 3):
        if _math.gcd(c, di.nskip) == 1 and \
                valid.shape[1] >= 12 * c * di.nskip:
            stride = c
            break
    if stride:
        # report the sensitivity trade once per process (a silent
        # sampling cut is the kind of thing that hides recall drops)
        import os as _os, sys as _sys
        if _os.environ.get("SMALT_TIMING") and \
                not getattr(device_map_step, "_stride_noted", False):
            device_map_step._stride_noted = True
            print(f"# device seeding: query positions sampled at "
                  f"stride {stride} (coprime with nskip={di.nskip}; "
                  f">= {valid.shape[1] // (stride * di.nskip)} "
                  f"phase-matching seeds kept per read)",
                  file=_sys.stderr)
        fwd = fwd[..., ::stride]
        rc = rc[..., ::stride]
        valid = valid[:, ::stride]
        qoffs = jnp.broadcast_to(
            stride * jnp.arange(valid.shape[1], dtype=jnp.int32),
            valid.shape)
    else:
        qoffs = jnp.broadcast_to(jnp.arange(valid.shape[1], dtype=jnp.int32),
                                 valid.shape)

    tol = max(k * 3 // di.nskip, 1)

    outs = []
    hits_used = jnp.zeros((B,), jnp.int32)
    hits_tot = jnp.zeros((B,), jnp.int32)
    for is_reverse, words in ((False, fwd), (True, rc)):
        if hilo:
            counts, base, hit = _lookup_hilo(di, words[0], words[1], valid)
        else:
            counts, base, hit = _lookup(di, words, valid)
        P_avail = valid.shape[1]
        # rarest seeds first: top-k of negated counts (0 = miss sorts last)
        key = jnp.where(hit, counts, 1 << 30)
        _, sel = jax.lax.top_k(-key, min(NSEED, P_avail))
        if P_avail > NSEED:
            # common pool: the most repeated words that still hit — they
            # carry the other copies of a repeat the rare pool can't see
            keyc = jnp.where(hit, counts, 0)
            _, selc = jax.lax.top_k(keyc, min(NSEED_COMMON, P_avail))
            sel = jnp.concatenate([sel, selc], axis=1)
        sel_base = jnp.take_along_axis(base, sel, 1)
        sel_true = jnp.take_along_axis(counts, sel, 1)
        sel_qoffs = jnp.take_along_axis(qoffs, sel, 1)
        sel_hit = jnp.take_along_axis(hit, sel, 1)
        # search-completeness bookkeeping (the fast-mode analogue of
        # results.c n_hits_used/n_hits_tot): `tot` counts every indexed
        # placement of the selected seed words, `used` only the ones the
        # MAXC expansion kept.  The per-word clamp bounds a single
        # megarepeat word so it cannot zero the whole read's mapq cap.
        sel_true = jnp.where(sel_hit, jnp.minimum(sel_true, 1 << 14), 0)
        hits_tot = hits_tot + jnp.sum(sel_true, axis=1)
        sel_counts = jnp.minimum(sel_true, MAXC)
        hits_used = hits_used + jnp.sum(sel_counts, axis=1)
        shift, ok = _expand_hits(di, sel_base, sel_counts, sel_qoffs,
                                 is_reverse)
        b1, v1, b2, v2, nc2 = _best_diagonal(shift, ok, tol)
        outs.append((b1, v1, b2, v2, nc2))
    return outs, hits_used, hits_tot


def device_seed_votes_sharded(di: DeviceIndex, reads, gb, axis="ip"):
    """Shard-local seeding that reproduces the single-device seed votes
    BIT-EXACTLY on every member of the `axis` mesh dimension.

    The round-4 winner-exchange design voted per shard and exchanged
    (votes, diagonal) winners — per-shard seed selection, per-shard
    MAXC budgets and boundary-split diagonal clusters all made the
    sharded decision differ from the unsharded one on repeat reads
    (13 of 9,733 reads at mapq > 6).  This version exchanges the hit
    COUNTS and the expanded SHIFT MULTISET instead:

      1. psum the per-query-word hit counts -> the global counts the
         single device would see; seed selection (rarest + common
         top-k) then runs REPLICATED on identical inputs;
      2. each shard expands its local slice of a selected word's
         position run under the global MAXC budget (all_gather of the
         selected words' local counts gives each shard its prefix, so
         the union is exactly the single device's first-min(count,
         MAXC) positions);
      3. all_gather the globalized shifts and run _best_diagonal on
         the union — the same valid multiset in the same sorted order
         as the single device, so best/second diagonals, votes and
         n2nd are equal by construction (the vote window min(N,16)
         saturates at 16 for both paddings).

    Returns (outs, hits_used, hits_tot) exactly as device_seed_votes,
    with diagonals already GLOBAL (shift + gb applied pre-gather) and
    the hits bookkeeping the replicated global values (no psum due)."""
    import math as _math
    reads = reads.astype(jnp.int32)
    B, Q = reads.shape
    k = di.wordlen
    hilo = di.words_lo is not None
    if hilo:
        fh, fl, rh, rl, valid = _query_words_hilo(reads, k)
        fwd = jnp.stack([fh, fl])
        rc = jnp.stack([rh, rl])
    else:
        fwd, rc, valid = _query_words(reads, k)
    stride = 0
    for c in (2, 3):
        if _math.gcd(c, di.nskip) == 1 and \
                valid.shape[1] >= 12 * c * di.nskip:
            stride = c
            break
    if stride:
        fwd = fwd[..., ::stride]
        rc = rc[..., ::stride]
        valid = valid[:, ::stride]
        qoffs = jnp.broadcast_to(
            stride * jnp.arange(valid.shape[1], dtype=jnp.int32),
            valid.shape)
    else:
        qoffs = jnp.broadcast_to(
            jnp.arange(valid.shape[1], dtype=jnp.int32), valid.shape)

    tol = max(k * 3 // di.nskip, 1)
    ip = jax.lax.psum(1, axis)
    my = jax.lax.axis_index(axis)

    outs = []
    hits_used = jnp.zeros((B,), jnp.int32)
    hits_tot = jnp.zeros((B,), jnp.int32)
    for is_reverse, words in ((False, fwd), (True, rc)):
        if hilo:
            counts, base, _hit = _lookup_hilo(di, words[0], words[1],
                                              valid)
        else:
            counts, base, _hit = _lookup(di, words, valid)
        counts_g = jax.lax.psum(counts, axis)
        hit_g = valid & (counts_g > 0)
        P_avail = valid.shape[1]
        key = jnp.where(hit_g, counts_g, 1 << 30)
        _, sel = jax.lax.top_k(-key, min(NSEED, P_avail))
        if P_avail > NSEED:
            keyc = jnp.where(hit_g, counts_g, 0)
            _, selc = jax.lax.top_k(keyc, min(NSEED_COMMON, P_avail))
            sel = jnp.concatenate([sel, selc], axis=1)
        sel_base = jnp.take_along_axis(base, sel, 1)      # shard-local
        sel_cnt_l = jnp.take_along_axis(counts, sel, 1)   # shard-local
        sel_true = jnp.take_along_axis(counts_g, sel, 1)
        sel_qoffs = jnp.take_along_axis(qoffs, sel, 1)
        sel_hit = jnp.take_along_axis(hit_g, sel, 1)
        sel_true = jnp.where(sel_hit, jnp.minimum(sel_true, 1 << 14), 0)
        hits_tot = hits_tot + jnp.sum(sel_true, axis=1)
        cap = jnp.minimum(sel_true, MAXC)
        hits_used = hits_used + jnp.sum(cap, axis=1)
        # my slice of the global first-`cap` positions of each word
        lc = jax.lax.all_gather(sel_cnt_l, axis)      # [ip, B, NSEL]
        before = jnp.sum(
            jnp.where(jnp.arange(ip)[:, None, None] < my, lc, 0),
            axis=0)
        quota = jnp.clip(cap - before, 0, sel_cnt_l)
        shift, ok = _expand_hits(di, sel_base, quota, sel_qoffs,
                                 is_reverse)
        shift = jnp.where(ok, shift + gb, -(1 << 30))
        # sort LOCALLY (scales), exchange the sorted runs, and merge
        # with a bitonic cascade; the quota partition leaves <= N
        # valid entries in the whole union, so the last N lanes of
        # the merged result are BITWISE the array the single device
        # sorts — the vote then runs at single-device width.  (A flat
        # sort of the ip*N-lane union was the measured per_ip
        # residual: 0.384 @ 4 flat, 0.62 with a tail-sliced sort, the
        # merge cascade removes most of the rest.)
        N_l = shift.shape[1]
        shift_l = jnp.sort(shift, axis=1)
        sh_all = jax.lax.all_gather(shift_l, axis)    # [ip, B, N]
        Np2 = 1
        while Np2 < N_l:
            Np2 *= 2
        runs = [jnp.pad(sh_all[s], ((0, 0), (Np2 - N_l, 0)),
                        constant_values=np.int32(-(1 << 30)))
                for s in range(ip)]
        while len(runs) > 1:
            nxt = [_merge_sorted_asc(runs[j], runs[j + 1])
                   for j in range(0, len(runs) - 1, 2)]
            if len(runs) % 2:
                nxt.append(jnp.pad(
                    runs[-1], ((0, 0), (runs[0].shape[1], 0)),
                    constant_values=np.int32(-(1 << 30))))
            runs = nxt
        s_u = runs[0][:, -N_l:]
        outs.append(_best_diagonal(s_u, None, tol, presorted=True))
    return outs, hits_used, hits_tot


def device_map_step(di: DeviceIndex, reads, matrix, gapopen_pos, gapext_pos):
    """Fast mapping step for a padded read batch.

    reads: [B, Q] integer mangled-alpha codes (0..7), padded reads
    all-7; any integer dtype (uint8 minimizes host->device transfer).
    Returns dict of per-read arrays: best score, second score, global
    window start, strand (0 fwd / 1 rc), seed votes.
    """
    reads = reads.astype(jnp.int32)
    B, Q = reads.shape
    k = di.wordlen
    S = window_len(Q)
    pad = window_pad(Q)
    outs, hits_used, hits_tot = device_seed_votes(di, reads)

    # three windows per read: the best diagonal of each strand plus the
    # better (by votes) of the two second diagonals — a 4th window adds
    # SW cost but only matters when BOTH strands' runner-ups do.
    # forward: alignment starts near diag*nskip; reverse: the RC read's
    # window ends at the last seed, so the origin backs off by Q-k.
    (b1f, v1f, b2f, v2f, nc2f), (b1r, v1r, b2r, v2r, nc2r) = outs
    org_f = -pad
    org_r = -(Q - k) - pad
    sel_rev = v2r > v2f
    b2 = jnp.where(sel_rev, b2r, b2f)
    v2 = jnp.where(sel_rev, v2r, v2f)
    nc2 = jnp.where(sel_rev, nc2r, nc2f)
    org2 = jnp.where(sel_rev, org_r, org_f)

    win_f, start_f = _gather_windows(di, b1f, S, org_f)
    win_r, start_r = _gather_windows(di, b1r, S, org_r)
    win_2, start_2 = _gather_windows(di, b2, S, org2)

    qc_f = reads
    qc_r = _revcomp_batch(reads)
    qc_2 = jnp.where(sel_rev[:, None], qc_r, qc_f)
    wins = jnp.concatenate([win_f, win_r, win_2], axis=0)       # [3B, S]
    starts = jnp.concatenate([start_f, start_r, start_2], axis=0)
    votes = jnp.concatenate([v1f, v1r, v2], axis=0)
    strands = jnp.concatenate(
        [jnp.zeros(B, jnp.int32), jnp.ones(B, jnp.int32),
         sel_rev.astype(jnp.int32)], axis=0)
    qcs = jnp.concatenate([qc_f, qc_r, qc_2], axis=0)
    slens = jnp.full((3 * B,), S, jnp.int32)
    has_seed = votes > 0
    # kilobase reads score in a band around the seed diagonal: the
    # window gather placed it `pad` columns in, so the band covers the
    # drift the window slack was sized for.  The tracked argmax anchors
    # the host tail's NARROW band (centred on the end diagonal tj - ti);
    # the tail verifies score >= device score and widens on a miss, so
    # the anchor is a pure accelerator.
    scores, tis, tjs = sw_scores(qcs, wins, slens, matrix, gapopen_pos,
                                 gapext_pos, track=True, band_pad=pad)
    scores = jnp.where(has_seed, scores, 0)
    v1 = jnp.where(sel_rev, v1r, v1f)
    return _pick_best(scores.reshape(3, B), starts.reshape(3, B),
                      strands.reshape(3, B), tis.reshape(3, B),
                      tjs.reshape(3, B), nc2, v1, v2,
                      hits_used, hits_tot)


def _pick_best(sc, st, sd, ti3, tj3, nc2, v1, v2, hits_used, hits_tot):
    """Rank the (3, B) scored windows into the per-read output dict
    (the selection tail of device_map_step, shared with the
    index-sharded step which merges scores over `ip` first)."""
    B = sc.shape[1]
    order = jnp.argsort(-sc, axis=0)
    best = jnp.take_along_axis(sc, order[0:1], 0)[0]
    second = jnp.take_along_axis(sc, order[1:2], 0)[0]
    best_start = jnp.take_along_axis(st, order[0:1], 0)[0]
    best_strand = jnp.take_along_axis(sd, order[0:1], 0)[0]
    second_start = jnp.take_along_axis(st, order[1:2], 0)[0]
    second_strand = jnp.take_along_axis(sd, order[1:2], 0)[0]
    best_ti = jnp.take_along_axis(ti3, order[0:1], 0)[0]
    best_tj = jnp.take_along_axis(tj3, order[0:1], 0)[0]
    # results.c's n_swatscor_2nd analogue: window-level runner-up
    # multiplicity, widened by the cluster estimate when the runner-up
    # window's strand saw multiple equally-voted far diagonals (unscored
    # repeat copies are plausible runner-ups too)
    n2nd = jnp.sum((sc == second[None, :]).astype(jnp.int32), axis=0) - \
        (best == second).astype(jnp.int32)
    n2nd = jnp.maximum(n2nd, nc2)
    # multi-copy ambiguity: several distinct far diagonal clusters tie
    # near the winner's vote count.  Each is a plausible equal-score
    # placement the 3-window budget cannot score, so confidence is at
    # best that of a random pick among copies (MAPSCOR_MAX_RANDOM,
    # results.c:220-224) — the tail caps mapq accordingly.
    ambig = (nc2 >= 2) & (v2 * 4 >= v1 * 3)
    return {
        "score": best,
        "score2": second,
        "start": best_start,
        "strand": best_strand,
        "start2": second_start,
        "strand2": second_strand,
        "hits_used": hits_used,
        "hits_tot": hits_tot,
        "n2nd": jnp.maximum(n2nd, 1),
        "ambig": ambig.astype(jnp.int32),
        "tb_i": best_ti,
        "tb_j": best_tj,
    }


OUT_KEYS = ("score", "score2", "start", "strand", "start2", "strand2",
            "hits_used", "hits_tot", "n2nd", "ambig", "tb_i", "tb_j")


def pack_outputs(out):
    """Stack the per-read output dict into ONE [len(OUT_KEYS), B] int32
    array ON DEVICE, so the pipeline starts one device-to-host copy per
    batch instead of one per output."""
    return jnp.stack([out[k].astype(jnp.int32) for k in OUT_KEYS])


def unpack_outputs(arr) -> dict:
    """Host-side inverse of pack_outputs (arr: [len(OUT_KEYS), B])."""
    return {k: arr[i] for i, k in enumerate(OUT_KEYS)}


def _revcomp_batch(reads):
    """Reverse complement [B, Q] alpha codes (nonstd codes unchanged)."""
    rev = reads[:, ::-1]
    std = (rev & 4) == 0
    return jnp.where(std, rev ^ 3, rev)


@dataclass
class ShardedDeviceIndex:
    """Range-sharded index + reference for genomes beyond one HBM.

    The concatenated reference splits into `n_shards` contiguous base
    ranges (aligned to nskip); each shard holds its slice of the
    reference (plus a right halo of `halo` bases so alignment windows
    crossing the cut are complete) and the index entries whose sampled
    position falls in its range, with positions rebased to shard-local
    tuple serials.  Per-shard arrays are padded to common sizes and
    stacked on a leading `ip` axis; under shard_map each device scans
    only its own shard and the per-read best combines with a max
    collective (SURVEY §2.3 P3: the seq-by-seq scan re-expressed as a
    reduction over position-range shards).

    Word-list padding uses an int32 sentinel larger than any packed
    2k-bit word, so binary-search lookups miss cleanly on pad rows.
    """
    wordlen: int
    nskip: int
    n_shards: int
    words: jnp.ndarray       # [ip, Wmax] int32, sentinel-padded
    starts: jnp.ndarray      # [ip, Wmax+1] int32
    pos: jnp.ndarray         # [ip, Pmax] int32 shard-local tuple serials
    ref_alpha: jnp.ndarray   # [ip, Lmax] int32, pad code 7 (scores 0)
    shard_base: jnp.ndarray  # [ip] int32 global base offset of the slice
    local_len: jnp.ndarray   # [ip] int32 valid bases in the slice
    ref_len: int             # global reference length
    hi_table: Optional[jnp.ndarray] = None  # [ip, 4^12, 2] (k=16..20)
    words_lo: Optional[jnp.ndarray] = None  # [ip, Wmax] int32
    lo_steps: int = 0

    WORD_SENTINEL = np.int32(0x7FFFFFFF)

    @classmethod
    def build(cls, refset: RefSet, idx: KmerIndex, n_shards: int,
              halo: int = 640) -> "ShardedDeviceIndex":
        if idx.wordlen > 20:
            raise ValueError("device path supports wordlen<=20")
        L = refset.total_len
        nskip = idx.nskip
        chunk = -(-L // n_shards)
        chunk = -(-chunk // nskip) * nskip          # multiple of nskip
        alpha = codec.alpha(refset.codes).astype(np.int32)
        words_np = idx.words.astype(np.int64)
        starts_np = idx.starts.astype(np.int64)
        pos_np = idx.pos.astype(np.int64)

        hilo = 2 * idx.wordlen > 31
        lo_bits = 2 * (idx.wordlen - DeviceIndex.HI_BASES) if hilo else 0

        shards = []
        for s in range(n_shards):
            lo_b = min(s * chunk, L)
            hi_b = min((s + 1) * chunk, L)
            lo_t, hi_t = lo_b // nskip, -(-hi_b // nskip)
            sel = (pos_np >= lo_t) & (pos_np < hi_t)
            # word slots with at least one position in range
            pidx = np.flatnonzero(sel)
            wslot = np.searchsorted(starts_np, pidx, side="right") - 1
            uw, first, counts = np.unique(wslot, return_index=True,
                                          return_counts=True)
            w64 = words_np[uw]
            w = np.zeros(1, np.int32) if hilo else w64.astype(np.int32)
            st = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
            p_local = (pos_np[pidx] - lo_t).astype(np.int32)
            sl_end = min(hi_b + halo, L)
            ref_slice = alpha[lo_b:sl_end]
            shards.append((w, st, p_local, ref_slice, lo_b, sl_end - lo_b,
                           w64))

        Wmax = max(max(len(s[1]) - 1 for s in shards), 1)
        Pmax = max(max(len(s[2]) for s in shards), 1)
        Lmax = max(max(len(s[3]) for s in shards), 1)
        words = np.full((n_shards, Wmax), cls.WORD_SENTINEL, np.int32)
        starts = np.zeros((n_shards, Wmax + 1), np.int32)
        pos = np.zeros((n_shards, Pmax), np.int32)
        refa = np.full((n_shards, Lmax), 7, np.int32)
        base = np.zeros(n_shards, np.int32)
        llen = np.zeros(n_shards, np.int32)
        hi_tables = lo_arrs = None
        lo_steps = 0
        if hilo:
            nhi = 1 << (2 * DeviceIndex.HI_BASES)
            hi_tables = np.zeros((n_shards, nhi, 2), np.int32)
            lo_arrs = np.zeros((n_shards, Wmax), np.int32)
        for s, (w, st, p, r, lo_b, ln, w64) in enumerate(shards):
            nW = len(st) - 1
            if hilo:
                hi = (w64 >> lo_bits)
                lo = (w64 & ((1 << lo_bits) - 1)).astype(np.int32)
                hi_tables[s, :, 0] = np.searchsorted(
                    hi, np.arange(nhi), side="left").astype(np.int32)
                hi_tables[s, :, 1] = np.searchsorted(
                    hi, np.arange(nhi), side="right").astype(np.int32)
                lo_arrs[s, : nW] = lo
                mb = int((hi_tables[s, :, 1].astype(np.int64) -
                          hi_tables[s, :, 0]).max()) if nW else 1
                lo_steps = max(lo_steps, max(
                    1, int(np.ceil(np.log2(max(mb, 1) + 1)))))
            else:
                words[s, : nW] = w
            starts[s, : len(st)] = st
            starts[s, len(st):] = st[-1] if len(st) else 0
            pos[s, : len(p)] = p
            refa[s, : len(r)] = r
            base[s] = lo_b
            llen[s] = ln
        return cls(wordlen=idx.wordlen, nskip=nskip, n_shards=n_shards,
                   words=jnp.asarray(words), starts=jnp.asarray(starts),
                   pos=jnp.asarray(pos), ref_alpha=jnp.asarray(refa),
                   shard_base=jnp.asarray(base), local_len=jnp.asarray(llen),
                   ref_len=L,
                   hi_table=(jnp.asarray(hi_tables) if hilo else None),
                   words_lo=(jnp.asarray(lo_arrs) if hilo else None),
                   lo_steps=lo_steps)


def _combine_over_ip(score, score2, start, strand, start2, strand2,
                     hits_used=None, hits_tot=None, n2nd=None,
                     ambig=None, hits_mode="sum", tb_i=None, tb_j=None):
    """Combine per-shard winners over the `ip` axis.

    The runner-up must consider BOTH each shard's own second-best AND
    the best of every other shard: a repeat whose two copies land in
    different shards has score2==score globally (mapq tie -> 0) even
    though every shard sees a unique local best.  Per shard, the
    runner-up candidate is its second if it holds the global best,
    else its best; a cross-shard tie of bests forces second=best with
    the secondary placement taken from a different best shard."""
    NEG = -(1 << 30)
    best = jax.lax.pmax(score, "ip")
    is_best = score == best

    def pickmax(x, m):
        return jax.lax.pmax(jnp.where(m, x, NEG), "ip")

    out_start = pickmax(start, is_best)
    out_strand = pickmax(strand, is_best)
    # A best-score shard whose placement differs from the picked primary
    # is genuine ambiguity; one at the SAME start is a duplicate sighting
    # (replicated index, or a halo overlap in the range-sharded index).
    genuine = is_best & (start != out_start)
    tie = jax.lax.psum(genuine.astype(jnp.int32), "ip") > 0
    v = jnp.where(is_best, score2, score)
    l2 = jnp.where(is_best, start2, start)
    d2 = jnp.where(is_best, strand2, strand)
    v2max = jax.lax.pmax(v, "ip")
    is2 = v == v2max
    second = jnp.where(tie, best, v2max)
    s2 = jnp.where(tie, pickmax(start, genuine), pickmax(l2, is2))
    t2 = jnp.where(tie, pickmax(strand, genuine), pickmax(d2, is2))
    out = {"score": best, "score2": second, "start": out_start,
           "strand": out_strand, "start2": s2, "strand2": t2}
    if tb_i is not None:
        # traceback anchor from the shard whose placement was picked as
        # primary (same window => same DP => same cell on duplicates)
        is_pick = is_best & (start == out_start)
        out["tb_i"] = pickmax(tb_i, is_pick)
        out["tb_j"] = pickmax(tb_j, is_pick)
    if hits_used is not None:
        if hits_mode == "sum":
            # range-sharded index: every shard saw a disjoint slice of
            # the position lists, so completeness counters add up
            out["hits_used"] = jax.lax.psum(hits_used, "ip")
            out["hits_tot"] = jax.lax.psum(hits_tot, "ip")
        else:
            # replicated index: every shard saw the same hits
            out["hits_used"] = jax.lax.pmax(hits_used, "ip")
            out["hits_tot"] = jax.lax.pmax(hits_tot, "ip")
        # conservative (largest) multiplicity of the runner-up score
        out["n2nd"] = jax.lax.pmax(n2nd, "ip")
        out["ambig"] = jax.lax.pmax(ambig, "ip")
    return out


def make_index_sharded_step(sdi: ShardedDeviceIndex, mesh: Mesh, matrix,
                            gapopen_pos, gapext_pos, pack=False):
    """SPMD mapping step with a REAL range-sharded index over `ip`:
    reads are data-parallel over `dp` and replicated over `ip`; each
    `ip` member runs seeding + diagonal voting on its own index shard
    only, the per-read vote winners are EXCHANGED (all_gather of
    (votes, diagonal) tuples — a few bytes per read), the global
    3-window selection is computed replicated, and each window is
    SW-scored once, by the shard that owns its reference range, into a
    psum merge.

    This is the round-4 fix for the r3 ip-axis inefficiency: the old
    design ran the full 3-windows-per-read SW pass on EVERY shard and
    pmax-merged the duplicates, so pass-1 compute was replicated ip
    times while only seeding scaled (VERDICT r3 #4; the reference's
    windowed scans never redo DP per window set, rmap.c:273-351).

    Round 5 replaces the winner-exchange voting with the bit-exact
    count/shift exchange (device_seed_votes_sharded): the sharded
    output is now byte-identical to the single-device step — the
    reference's own determinism contract (test/mthread_test.py) holds
    with no mapq>6 carve-out."""
    ip = mesh.shape["ip"]
    assert ip == sdi.n_shards, (ip, sdi.n_shards)
    hilo = sdi.words_lo is not None
    nskip = sdi.nskip
    k = sdi.wordlen
    REF = sdi.ref_len

    def step(reads, words, starts, pos, refa, base, llen,
             hi_table=None, words_lo=None):
        di = DeviceIndex(
            wordlen=sdi.wordlen, nskip=sdi.nskip,
            words=words[0], starts=starts[0], pos=pos[0],
            ref_alpha=refa[0], ref_len=llen[0],
            hi_table=hi_table[0] if hilo else None,
            words_lo=words_lo[0] if hilo else None,
            lo_steps=sdi.lo_steps)
        B, Q = reads.shape
        S = window_len(Q)
        pad = window_pad(Q)
        gb = base[0] // nskip                 # shard-local -> global
        outs, hu, ht = device_seed_votes_sharded(
            di, reads.astype(jnp.int32), gb)
        ((bfd, vfg, b2fd, v2fg, nc2f),
         (brd, vrg, b2rd, v2rg, nc2r)) = outs
        sel_rev = v2rg > v2fg
        org_f = -pad
        org_r = -(Q - k) - pad
        b2d = jnp.where(sel_rev, b2rd, b2fd)
        v2g = jnp.where(sel_rev, v2rg, v2fg)
        org2 = jnp.where(sel_rev, org_r, org_f)

        def gstart(diag, org):
            return jnp.clip(diag * nskip + org, 0, max(REF - S, 0))

        starts3 = jnp.stack([gstart(bfd, org_f), gstart(brd, org_r),
                             gstart(b2d, org2)])            # [3, B]
        strands3 = jnp.stack([jnp.zeros(B, jnp.int32),
                              jnp.ones(B, jnp.int32),
                              sel_rev.astype(jnp.int32)])
        votes3 = jnp.stack([vfg, vrg, v2g])
        has3 = votes3 > 0

        # ownership: the shard whose base range contains the window
        # start GATHERS it (halo >= S covers the right spill); the
        # gathered contents psum into a replicated [N3, S] buffer and
        # every shard then SCORES a balanced my::ip slice.  The r4/r5a
        # design compacted owned windows under a fair-share CAP and
        # scored them on the owner — but ownership skew is unbounded
        # on real genomes (a satellite array or any clipped-to-0
        # degenerate diagonal piles windows onto one shard; measured
        # 564/512 overflow per 256-read group on the 64 Mb surrogate,
        # silently dropping windows and breaking single-device
        # identity).  Exchanging the window BYTES (~N3*S ints, <1 MB)
        # removes the cap entirely: balance is exact by construction,
        # every window scores once, and the content equals the single
        # device's gather bit-for-bit.
        my = jax.lax.axis_index("ip")
        base_all = jax.lax.all_gather(base[0], "ip")         # [ip]
        owner = jnp.zeros((3, B), jnp.int32)
        for i in range(1, ip):
            owner = owner + (starts3 >= base_all[i]).astype(jnp.int32)
        N3 = 3 * B
        ownN = owner.reshape(N3)
        hasN = has3.reshape(N3)
        st_loc = starts3.reshape(N3) - base[0]
        offs = jnp.arange(S, dtype=jnp.int32)
        gidx = jnp.clip(st_loc[:, None] + offs[None, :], 0,
                        refa[0].shape[0] - 1)
        mine = (ownN == my) & hasN
        content = jnp.where(mine[:, None],
                            refa[0][gidx].astype(jnp.int32), 0)
        content = jax.lax.psum(content, "ip")    # replicated windows
        qc_f = reads.astype(jnp.int32)
        qc_r = _revcomp_batch(qc_f)
        qc_2 = jnp.where(sel_rev[:, None], qc_r, qc_f)
        qc3 = jnp.stack([qc_f, qc_r, qc_2]).reshape(N3, Q)
        NR = -(-N3 // ip)
        ridx = jnp.arange(NR, dtype=jnp.int32) * ip + my
        pad_row = ridx >= N3
        rows = jnp.minimum(ridx, N3 - 1)
        qcs = qc3[rows]
        wins = content[rows]
        slens = jnp.where(pad_row, 0, S)
        sc, ti, tj = sw_scores(qcs, wins, slens, matrix, gapopen_pos,
                               gapext_pos, track=True)
        # scatter my slice to [3B] (+1 dump slot for pad rows), psum:
        # each window is scored by exactly one shard
        dump = jnp.where(pad_row, N3, rows)

        def scat(x):
            return jnp.zeros(N3 + 1, jnp.int32).at[dump].add(x)[:N3]

        sc3 = jax.lax.psum(scat(jnp.where(pad_row, 0, sc)), "ip")
        ti3 = jax.lax.psum(scat(jnp.where(pad_row, 0, ti)), "ip")
        tj3 = jax.lax.psum(scat(jnp.where(pad_row, 0, tj)), "ip")
        sc3 = jnp.where(hasN, sc3, 0)

        # seed votes / counters are already the replicated GLOBAL
        # values (device_seed_votes_sharded) — no merge collectives
        nc2g = jnp.where(sel_rev, nc2r, nc2f)
        v1g = jnp.where(sel_rev, vrg, vfg)
        return _pick_best(sc3.reshape(3, B), starts3, strands3,
                          ti3.reshape(3, B), tj3.reshape(3, B),
                          nc2g, v1g, v2g, hu, ht)

    in_specs = [P("dp", None),        # reads
                P("ip", None), P("ip", None), P("ip", None),
                P("ip", None), P("ip"), P("ip")]
    if hilo:
        in_specs += [P("ip", None, None), P("ip", None)]
    out_specs = {k: P("dp") for k in OUT_KEYS}
    fn = jax.shard_map(step, mesh=mesh, in_specs=tuple(in_specs),
                       out_specs=out_specs, check_vma=False)
    if pack:
        jfn = jax.jit(lambda *a: pack_outputs(fn(*a)))
    else:
        jfn = jax.jit(fn)

    def run(reads):
        args = [reads, sdi.words, sdi.starts, sdi.pos, sdi.ref_alpha,
                sdi.shard_base, sdi.local_len]
        if hilo:
            args += [sdi.hi_table, sdi.words_lo]
        return jfn(*args)

    return run


def _index_args(di: DeviceIndex):
    """(arrays, meta) of a DeviceIndex: the arrays travel as jit
    ARGUMENTS (pytree leaves), not closure constants — large
    closed-over arrays (the 512 MB direct table) otherwise get baked
    into the HLO as constants, and a mesh step would move them again
    on every call."""
    arrs = {"words": di.words, "starts": di.starts, "pos": di.pos,
            "ref": di.ref_alpha}
    if di.table is not None:
        arrs["table"] = di.table
    if di.words_lo is not None:
        arrs["hi_table"] = di.hi_table
        arrs["words_lo"] = di.words_lo
    return arrs, (di.wordlen, di.nskip, di.ref_len, di.lo_steps)


def _index_from_args(arrs, meta) -> DeviceIndex:
    return DeviceIndex(wordlen=meta[0], nskip=meta[1],
                       words=arrs["words"], starts=arrs["starts"],
                       pos=arrs["pos"], ref_alpha=arrs["ref"],
                       ref_len=meta[2], table=arrs.get("table"),
                       hi_table=arrs.get("hi_table"),
                       words_lo=arrs.get("words_lo"), lo_steps=meta[3])


def make_device_step(di: DeviceIndex, matrix, gapopen_pos, gapext_pos,
                     pack=False):
    """Single-device jitted mapping step, the index arrays passed as
    jit arguments (`_index_args`).
    pack=True returns the packed [len(OUT_KEYS), B] int32 array
    (one host fetch per batch) instead of the dict."""
    arrs, meta = _index_args(di)

    @jax.jit
    def step(reads, arrs):
        out = device_map_step(_index_from_args(arrs, meta), reads, matrix,
                              gapopen_pos, gapext_pos)
        return pack_outputs(out) if pack else out

    return lambda reads: step(reads, arrs)


def make_sharded_step(di: DeviceIndex, mesh: Mesh, matrix,
                      gapopen_pos, gapext_pos, pack=False):
    """SPMD mapping step over a ('dp', 'ip') mesh.

    Reads shard over `dp`.  The index arrays are replicated over the
    mesh once, here, and passed as jit arguments (`_index_args`); each
    `ip` member scans a disjoint slice of the diagonal space and
    per-read results combine with a max over `ip` (jax.lax.pmax).
    make_index_sharded_step range-shards the index instead.
    """
    ip = mesh.shape.get("ip", 1)
    arrs, meta = _index_args(di)
    arrs = jax.device_put(arrs, NamedSharding(mesh, P()))

    def step(reads, arrs):
        out = device_map_step(_index_from_args(arrs, meta), reads, matrix,
                              gapopen_pos, gapext_pos)
        if ip > 1:
            out = _combine_over_ip(out["score"], out["score2"],
                                   out["start"], out["strand"],
                                   out["start2"], out["strand2"],
                                   out["hits_used"], out["hits_tot"],
                                   out["n2nd"], out["ambig"],
                                   hits_mode="max",
                                   tb_i=out["tb_i"], tb_j=out["tb_j"])
        return out

    fn = jax.shard_map(step, mesh=mesh, in_specs=(P("dp", None), P()),
                       out_specs={k: P("dp") for k in OUT_KEYS},
                       check_vma=False)
    jfn = jax.jit((lambda r, a: pack_outputs(fn(r, a))) if pack else fn)
    return lambda reads: jfn(reads, arrs)
