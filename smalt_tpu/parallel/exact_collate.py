"""Device-exact seeding/collation: the exact engine's front half as ONE
jitted device program.

This is the round-4 north-star work item: the reference's per-read
seed -> collate -> pass-1 dataflow (hashhit.c:1593-1763 collection,
segment.c:396-1057 seeds/segments/candidates, rmap.c:588-788 pass-1
scoring), already re-implemented as host C in native/mapcore.c, runs
here as a batched fixed-shape JAX pipeline with semantics equal to the
C bit for bit — differential-tested in tests/test_device_exact.py.
The host keeps only the stages whose NR-quicksort tie permutations
make them inherently sequential (hit-info rank selection and the
candidate depth sort, ~5% of exact-lane time) plus pass 2.

Division of labour per block of reads:

  host   hit-info + NR rank selection per strand (mc_hitinfo_short2),
         cover deficits, hit-number stats; ships a per-(read,strand)
         SELECTED-SEED MASK over query positions.
  device THIS MODULE: re-derives hit info from the resident index
         (rolling words, bad-base windows, ring repeat filter, count
         cutoff — mc_hitinfo_collect semantics), intersects with the
         host mask, expands in-interval hits (pos_range binary
         search), sorts packed (shift, qoffs) keys, forms seeds /
         constant-shift segments / regions and runs the greedy
         candidate merge (segment.c semantics) in one sequential scan,
         then scores every SIMD-eligible candidate window with the
         full-matrix device scorer — one dispatch per block.
  host   verifies checksums, runs the NR depth sort over the returned
         rows, builds the pass-2 state; fl_pass2_block finishes
         byte-identically (pass-1 replay with device scores, pass 2,
         report, SAM).

Any per-read capacity overflow (hits > H, candidates > C, nseg > 255)
or checksum/simd mismatch flags the read for a full host re-stage, so
output equality never depends on the device.

Exactness notes:
- Packed-hit keys are unique per strand (one position appears once per
  word, qoffs disambiguates words), so the u64 hit sort has a single
  answer and lax.sort on the (shift, qoffs) key pair reproduces the
  host's sort_u64 exactly (split keys: fwd shift = 2^32 + p - q/nskip
  is represented as k1 = p - q/nskip, the bias being strand-constant).
- In seq-by-seq collection (the only mode this path serves) the hit
  SET is independent of the host's seed-rank tie order (the budget
  ceiling cannot trigger below H <= 8192, the minimum per-read budget),
  and qm carries no NORMHIT entries, so segment.c's min_ktup reduction
  always yields 1 — regions are never skipped for size.  Both facts
  are exploited here and pinned by the differential tests.

Packed candidate row (6 x int32), matching mapcore.c's out11 fields
{qs,qe,rs,re,shiftoffs,shift2mm,srange,cover,flag,nseg,seqidx}:

  w0 = qs | qe<<8 | cover<<16 | nseg<<24      (all <= 255, gated)
  w1 = rs   (k-tuple serial, int32 — gated ref_len < 2^31)
  w2 = re   (k-tuple serial)
  w3 = shiftoffs (diff_shift)
  w4 = shift2mm
  w5 = srange(22 bits) | seqidx<<22 (9 bits) | mmali<<31

The REVERSE flag is implied by the strand lane (host adds it).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

NREPEATS = 4           # hashhit.c:42 ring size
SEG_DIFFSHIFT = 3      # segment.c SEGMENTING_DIFFSHIFT
EDGE_BAND_FACTOR = 4   # segment.c:137
MAX_BANDEDGE_2POW = 4  # segment.c:142
MINLEN_QUERY_STRIPED = 32
BWSCAL_QLEN = 48
BIG = np.int32(0x7FFFFFF0)
MMALI_BIT = np.int32(np.uint32(1 << 31))


@dataclass(frozen=True)
class CollateCfg:
    wordlen: int
    nskip: int
    maxhit: int            # ktuple_maxhit (per-word cutoff)
    B: int                 # reads per block
    Q: int                 # padded read length (<= 255)
    H: int = 512           # hits cap per (read, strand, interval)
    C: int = 16            # candidate cap per (read, strand, interval)
    P: int = 0             # pool cap (default 8*B)
    V: int = 1             # interval SLOTS in the device V loop
    host_hits: bool = False  # host ships padded (k1, k2) hit keys
    NS: int = 1            # reference sequences; > 1 (host_hits only):
                           # host also ships per-hit seq ids and the
                           # scan breaks at interval boundaries
    SPAD: int = 128        # pass-1 window pad (oversize -> restage)

    @property
    def pool(self):
        return self.P or 6 * self.B


def _hitinfo_device(jnp, cfg, codes, qbad, qlens, table):
    """Per-strand device hit info (mc_hitinfo_collect semantics):
    lane t = the k-mer starting at query position t.  Returns
    (is_seed [B,2,Q] bool, cnt [B,2,Q] i32, base [B,2,Q] i32)."""
    k = cfg.wordlen
    B, Q = cfg.B, cfg.Q
    c2 = (codes & 3).astype(jnp.int32)                 # [B, Q]
    bad = qbad | ((codes & 4) != 0)                    # [B, Q] bool
    t_iota = jnp.arange(Q, dtype=jnp.int32)[None, :]

    # rolling words, both strands, as k shifted ORs over static slices
    # (fwd: base j at bit 2*(k-1-j); rev: complement at bit 2*j)
    wf = jnp.zeros((B, Q), jnp.int32)
    wr = jnp.zeros((B, Q), jnp.int32)
    for j in range(k):
        col = jnp.pad(c2[:, j:], ((0, 0), (0, j)))     # c2[t+j] at lane t
        wf = wf | (col << (2 * (k - 1 - j)))
        wr = wr | ((col ^ 3) << (2 * j))

    # window validity: t <= qlen-k and no bad base inside [t, t+k)
    badc = jnp.pad(jnp.cumsum(bad.astype(jnp.int32), axis=1),
                   ((0, 0), (1, 0)))                   # exclusive prefix
    hi = jnp.minimum(t_iota + k, Q)
    nbad = jnp.take_along_axis(badc, hi, axis=1) - badc[:, :Q]
    ok = (nbad == 0) & (t_iota <= (qlens[:, None] - k))

    # ring repeat filter: w equals any of the previous <= 4 OK windows
    # (hashhit.c:325-342; the ring holds every OK window regardless of
    # its own later classification).  okpos[r] = position of the r-th
    # OK window, via one masked sort.
    okrank = jnp.cumsum(ok.astype(jnp.int32), axis=1) - 1   # [B, Q]
    okpos = jnp.sort(jnp.where(ok, t_iota, BIG), axis=1)
    words2 = jnp.stack([wf, wr], axis=1)               # [B, 2, Q]
    rep = jnp.zeros((B, 2, Q), bool)
    for d in range(1, NREPEATS + 1):
        r_prev = okrank - d
        has = ok & (r_prev >= 0)
        pidx = jnp.take_along_axis(okpos, jnp.maximum(r_prev, 0), axis=1)
        pidx = jnp.minimum(pidx, Q - 1)
        pw = jnp.take_along_axis(
            words2, jnp.broadcast_to(pidx[:, None, :], (B, 2, Q)), axis=2)
        rep = rep | (has[:, None, :] & (pw == words2))

    # direct-address lookup: pair {starts[w], starts[w+1]}
    pair = table[jnp.where(ok[:, None, :] & ~rep, words2, 0)]
    base = pair[..., 0]
    cnt = pair[..., 1] - base
    is_seed = ok[:, None, :] & ~rep & (cnt >= 1)
    if cfg.maxhit > 0:
        is_seed = is_seed & (cnt <= cfg.maxhit)
    cnt = jnp.where(is_seed, cnt, 0)
    base = jnp.where(is_seed, base, 0)
    return is_seed, cnt, base


def _lower_bound(jnp, arr, lo0, hi0, target, steps):
    """Vectorized lower_bound over per-lane slices [lo0, hi0) of a 1-D
    device array: smallest i with arr[i] >= target."""
    n = arr.shape[0]
    lo, hi = lo0, hi0
    for _ in range(steps):
        active = lo < hi
        mid = (lo + hi) >> 1
        v = arr[jnp.clip(mid, 0, n - 1)]
        go = active & (v < target)
        lo = jnp.where(go, mid + 1, lo)
        hi = jnp.where(active & ~go, mid, hi)
    return lo


def _expand_hits(jnp, cfg, pos, a, nh, strand_is_rev):
    """Expand selected seeds' in-range hits into packed sort keys
    (k1 = p -/+ q/nskip, k2 = q = the seed's query offset), padded with
    BIG.  a/nh: [R, Q] per-seed slice start/length (0 for non-seeds)."""
    R = a.shape[0]
    H, Q = cfg.H, cfg.Q
    npos = pos.shape[0]
    cum = jnp.cumsum(nh, axis=1)                      # inclusive [R, Q]
    total = cum[:, -1]
    cum_ex = jnp.pad(cum, ((0, 0), (1, 0)))[:, :Q]    # exclusive
    h_iota = jnp.arange(H, dtype=jnp.int32)[None, :]
    # seed of slot h: smallest s with cum[s] > h (binary search)
    lo = jnp.zeros((R, H), jnp.int32)
    hi = jnp.full((R, H), Q - 1, jnp.int32)
    for _ in range(9):                                # 2^9 >= Q + 1
        mid = (lo + hi) >> 1
        v = jnp.take_along_axis(cum, mid, axis=1)
        go = v <= h_iota
        lo = jnp.where(go, mid + 1, lo)
        hi = jnp.where(go, hi, mid)
    sid = jnp.minimum(lo, Q - 1)                      # [R, H]
    valid = h_iota < total[:, None]
    l = h_iota - jnp.take_along_axis(cum_ex, sid, axis=1)
    pidx = jnp.take_along_axis(a, sid, axis=1) + l
    p = pos[jnp.clip(pidx, 0, npos - 1)]
    q = sid                                           # lane t == qoffs
    qd = q // cfg.nskip
    k1 = jnp.where(strand_is_rev[:, None], p + qd, p - qd)
    k1 = jnp.where(valid, k1, BIG).astype(jnp.int32)
    k2 = jnp.where(valid, q, BIG).astype(jnp.int32)
    return k1, k2, valid, total


def _segcand_scan(jax, jnp, cfg, k1, k2, valid, mdsh, mincover,
                  strand_is_rev, ivl=None):
    """The sequential heart: ONE scan over the sorted hits forming
    seeds (segment.c:455), constant-shift segments (segment.c:535),
    regions (segment.c:396, min_ktup == 1 — module docstring) and the
    greedy candidate merge (segment.c:1140 + derriveSEGCAND 929),
    emitting <= 2 packed rows per step (a break-emit plus a
    region-close emit can coincide).  Returns (emit flags [R, 2H+2],
    rows [R, 2H+2, 7], bad [R]); row field 6 is the candidate's
    interval id (0 without `ivl`).

    ivl (optional [R, H] i32): interval (sequence) id per sorted hit.
    The C engine collates each base interval separately (seq-by-seq,
    rmap.c's SEQBYSEQ regime), so a combined scan must break regions
    and shift-segments exactly at interval boundaries — hits are
    sorted with ivl as the LEADING key, one forced region_start per
    boundary reproduces the per-interval scan, and emission order
    stays (interval, emission) as the pool contract requires."""
    R, H = k1.shape
    k = cfg.wordlen
    nskip = cfg.nskip
    Q = cfg.Q
    i32 = jnp.int32
    pos_iota = jnp.arange(Q, dtype=i32)[None, :]

    # pairwise flags vs the previous sorted element
    d1 = k1 - jnp.pad(k1, ((0, 0), (1, 0)))[:, :H]
    prev_k2 = jnp.pad(k2, ((0, 0), (1, 0)))[:, :H]
    e_iota = jnp.arange(H, dtype=i32)[None, :]
    same_region = (d1 < mdsh[:, None]) | \
                  ((d1 == mdsh[:, None]) & (k2 < prev_k2))
    same_shift = (d1 == 0) & (e_iota > 0)
    if ivl is not None:
        prev_ivl = jnp.pad(ivl, ((0, 0), (1, 0)))[:, :H]
        ivl_change = (ivl != prev_ivl) & (e_iota > 0)
        same_region = same_region & ~ivl_change
        same_shift = same_shift & ~ivl_change
    region_start = (e_iota == 0) | ~same_region

    zeros = jnp.zeros((R,), i32)
    fal = jnp.zeros((R,), bool)

    def seg_bounds(st):
        """calcSegmentBoundaries (segment.c:637-668) from the segment's
        first seed (seg_shift, seg_q0first) and the just-closed last
        seed (seed_q0, seed_lastq)."""
        seed_len = st["seed_lastq"] - st["seed_q0"]
        qs = st["seg_q0first"]
        qe = st["seed_q0"] + seed_len - 1
        sh = st["seg_shift"]
        ext = (seed_len - k) // nskip
        rs = jnp.where(strand_is_rev,
                       sh - st["seed_q0"] // nskip - ext,
                       sh + qs // nskip)
        re = jnp.where(strand_is_rev,
                       sh - qs // nskip,
                       sh + st["seed_q0"] // nskip + ext)
        return qs, qe, rs, re

    def pack_row(c, reg_ivl):
        """derriveSEGCAND final fields from candidate accumulators.
        reg_ivl: the interval id of the candidate's region (candidates
        never span intervals: region_start is forced at boundaries)."""
        qs, qe, rs, re = c["qs"], c["qe"], c["rs"], c["re"]
        sh_start = jnp.where(strand_is_rev,
                             rs + (qe - k + 1) // nskip,
                             rs - qs // nskip)
        diff_shift = c["shiftmin"] - sh_start
        srange = c["lastshift"] - c["shiftmin"]
        mmali = c["maxcovseg"] >= mincover
        sh2mm = jnp.where(mmali, c["shift2mm"] - sh_start, 0)
        w0 = (qs | (qe << 8) | (c["cover"] << 16) |
              (jnp.minimum(c["nseg"], 255) << 24))
        w5 = (srange & 0x3FFFFF) | jnp.where(mmali, MMALI_BIT, 0)
        bad = ((c["nseg"] > 255) | (srange < 0) |
               (srange >= (1 << 22)) | (c["cover"] > 255) |
               (qs < 0) | (qe > 255))
        return jnp.stack([w0, rs, re, diff_shift, sh2mm, w5,
                          reg_ivl], 1), bad

    def step(st, xs):
        k1e, k2e, val, rstart, sshift, ivl_e = xs
        force = st["force"]
        open_seed = st["open_seed"]

        # classify the incoming hit
        merge = (val & ~rstart & sshift & open_seed &
                 (k2e <= st["seed_lastq"]) &
                 ((k2e - st["seed_q0"]) % nskip == 0))
        new_seed = val & ~merge
        seg_cont = (new_seed & ~rstart & open_seed &
                    (k1e == st["seg_shift"]) &
                    ((k2e - st["seg_q0first"]) % nskip == 0))
        close_seg = open_seed & ((new_seed & ~seg_cont) | force)
        close_cand = open_seed & ((val & rstart) | force)

        # ---- segment completion + greedy candidate decision ----
        seed_len = st["seed_lastq"] - st["seed_q0"]
        seg_cover = st["seg_cover_done"] + seed_len
        qs_s, qe_s, rs_s, re_s = seg_bounds(st)
        cand_open = st["cand_open"]
        brk = (close_seg & cand_open &
               (2 * st["seg_covernew"] < seg_cover) &
               (st["c"]["cover"] >= mincover))
        fresh = (close_seg & ~cand_open) | brk

        row_b, bad_b = pack_row(st["c"], st["reg_ivl"])
        emit0_f = brk                      # break always emits
        emit0 = jnp.where(brk[:, None], row_b, jnp.zeros((R, 7), i32))
        bad = st["bad"] | (brk & bad_b)

        upd_max = seg_cover > st["c"]["maxcovseg"]
        c = st["c"]
        cn = dict(
            cover=jnp.where(fresh, seg_cover,
                            c["cover"] + st["seg_covernew"]),
            qs=jnp.where(fresh, qs_s, jnp.minimum(c["qs"], qs_s)),
            qe=jnp.where(fresh, qe_s, jnp.maximum(c["qe"], qe_s)),
            rs=jnp.where(fresh, rs_s, jnp.minimum(c["rs"], rs_s)),
            re=jnp.where(fresh, re_s, jnp.maximum(c["re"], re_s)),
            shiftmin=jnp.where(fresh, st["seg_shift"], c["shiftmin"]),
            maxcovseg=jnp.where(fresh | upd_max, seg_cover,
                                c["maxcovseg"]),
            shift2mm=jnp.where(fresh | upd_max, st["seg_shift"],
                               c["shift2mm"]),
            lastshift=jnp.where(close_seg, st["seg_shift"],
                                c["lastshift"]),
            nseg=jnp.where(fresh, 1,
                           jnp.where(close_seg, c["nseg"] + 1,
                                     c["nseg"])),
        )
        c = {kk: jnp.where(close_seg, cn[kk], st["c"][kk]) for kk in cn}
        cand_open = cand_open | close_seg
        cmask = st["cand_mask"]
        smask = st["seg_mask"]
        cmask = jnp.where(close_seg[:, None],
                          jnp.where(fresh[:, None], smask,
                                    cmask | smask),
                          cmask)

        # region close: emit the (possibly just-integrated) candidate
        row_r, bad_r = pack_row(c, st["reg_ivl"])
        emit_r = close_cand & cand_open & (c["cover"] >= mincover)
        emit1_f = emit_r
        emit1 = jnp.where(emit_r[:, None], row_r, jnp.zeros((R, 7), i32))
        bad = bad | (emit_r & bad_r)
        cand_open = cand_open & ~close_cand
        cmask = jnp.where(close_cand[:, None],
                          jnp.zeros_like(cmask), cmask)

        # ---- start / extend structures with the incoming hit ----
        lo = jnp.where(merge, st["seed_lastq"], k2e)
        hi_b = jnp.where(val, k2e + k, k2e)            # empty if !val
        bits = ((pos_iota >= lo[:, None]) & (pos_iota < hi_b[:, None]) &
                val[:, None])
        covnew_add = jnp.sum((bits & ~cmask).astype(i32), axis=1)
        reset_seg = close_seg | ~open_seed
        smask = jnp.where(reset_seg[:, None],
                          jnp.zeros_like(smask), smask) | bits
        covnew = jnp.where(reset_seg, 0, st["seg_covernew"]) + \
            jnp.where(val, covnew_add, 0)
        scover_done = jnp.where(reset_seg, 0, st["seg_cover_done"]) + \
            jnp.where(new_seed & open_seed & ~close_seg, seed_len, 0)

        ns = dict(
            open_seed=(open_seed & ~force) | new_seed,
            force=st["force"],
            seed_q0=jnp.where(new_seed, k2e, st["seed_q0"]),
            seed_lastq=jnp.where(val, k2e + k, st["seed_lastq"]),
            seg_shift=jnp.where(new_seed & ~seg_cont, k1e,
                                st["seg_shift"]),
            seg_q0first=jnp.where(new_seed & ~seg_cont, k2e,
                                  st["seg_q0first"]),
            seg_cover_done=scover_done,
            seg_covernew=covnew,
            seg_mask=smask,
            cand_mask=cmask,
            cand_open=cand_open,
            c=c,
            bad=bad,
            reg_ivl=jnp.where(val & rstart, ivl_e, st["reg_ivl"]),
        )
        return ns, (emit0_f, emit0, emit1_f, emit1)

    st0 = dict(
        open_seed=fal, force=fal,
        seed_q0=zeros, seed_lastq=zeros,
        seg_shift=zeros, seg_q0first=zeros,
        seg_cover_done=zeros, seg_covernew=zeros,
        seg_mask=jnp.zeros((R, Q), bool),
        cand_mask=jnp.zeros((R, Q), bool),
        cand_open=fal,
        c=dict(cover=zeros, qs=zeros, qe=zeros, rs=zeros, re=zeros,
               shiftmin=zeros, maxcovseg=zeros, shift2mm=zeros,
               lastshift=zeros, nseg=zeros),
        bad=fal,
        reg_ivl=zeros,
    )
    ivl_xs = (jnp.zeros((R, H), i32) if ivl is None else ivl).T
    xs = (k1.T, k2.T, valid.T, region_start.T, same_shift.T, ivl_xs)
    stF, ys = jax.lax.scan(step, st0, xs)
    # epilogue: close everything still open
    stF = dict(stF)
    stF["force"] = jnp.ones((R,), bool)
    _, ysE = step(stF, (zeros, zeros, fal, fal, fal, zeros))
    e0f, e0, e1f, e1 = ys                    # [H, R] / [H, R, 6]
    xe0f, xe0, xe1f, xe1 = ysE
    ef = jnp.concatenate(
        [jnp.stack([e0f, e1f], 1).reshape(2 * H, R),
         xe0f[None], xe1f[None]], axis=0)                # [2H+2, R]
    er = jnp.concatenate(
        [jnp.stack([e0, e1], 1).reshape(2 * H, R, 7),
         xe0[None], xe1[None]], axis=0)                  # [2H+2, R, 7]
    return ef.T, jnp.transpose(er, (1, 0, 2)), stF["bad"]


def _compact_rows(jax, jnp, cfg, ef, er):
    """Per-lane compaction of the scan emissions (emission order
    preserved): [R, E(,F)] -> rows [R, C, F], counts [R], overflow."""
    R, E = ef.shape
    C = cfg.C
    F = er.shape[2]
    key = jnp.where(ef, jnp.arange(E, dtype=jnp.int32)[None, :], BIG)
    ops = jax.lax.sort([key] + [er[:, :, f] for f in range(F)],
                       num_keys=1)
    rows = jnp.stack([ops[1 + f][:, :C] for f in range(F)], 2)
    counts = jnp.sum(ef.astype(jnp.int32), axis=1)
    slot_ok = jnp.arange(C, dtype=jnp.int32)[None, :] < counts[:, None]
    return jnp.where(slot_ok[:, :, None], rows, 0), counts, counts > C


def build_exact_collate(di, ivals_np, matrix_np, go, ge, cfg: CollateCfg):
    """Build the jitted device-exact collation + pass-1 scoring step.

    di: parallel.mesh.DeviceIndex (direct table required: 2k <= 28)
    ivals_np: [V, 3] int64 {start, end, seqidx} global base intervals
    (the engine's seq-by-seq `_seq_ivals`).

    fn(codes [B,Q] u8 mangled, qbad [B,Q] bool, selmask [B,2,Q] u8,
       qlens [B] i32, min_cover [B] i32) ->
      pool      [P, 6] i32  packed candidate rows, per-read contiguous
                            in (strand, interval, emission) order
      counts2   [B, 2] i32  rows per read per strand (F, R)
      scores    [P] i32     pass-1 window score, -1 = not SIMD-eligible
      cksum     [B, 2, 2]   device hit-info checksum per strand
      fallback  [B] bool    device-side per-read fallback flags
    """
    import jax
    import jax.numpy as jnp
    from ..device import ensure_compile_cache
    from ..ops.sw import sw_scores

    ensure_compile_cache()
    if not cfg.host_hits and di.table is None:
        raise ValueError("device-exact hit expansion needs the "
                         "direct-address table (host_hits does not)")
    k = cfg.wordlen
    nskip = cfg.nskip
    B, Q, H, C, V = cfg.B, cfg.Q, cfg.H, cfg.C, cfg.V
    # host_hits: V interval SLOTS stay 1 (one combined scan); ivals_np
    # still carries every sequence for the geometry offsets
    assert cfg.host_hits or V == len(ivals_np)
    P = cfg.pool
    R = 2 * B
    # the big index arrays are passed as ARGUMENTS, not closure
    # captures: captured jnp arrays bake into the HLO as constants,
    # and a 4^k-pair table is hundreds of MB.  As arguments they stay
    # device-resident.
    table_res = di.table              # [4^k, 2] i32
    pos_res = di.pos                  # [npos] i32
    ref_res = di.ref_alpha            # [L] i32
    matrix = jnp.asarray(matrix_np.astype(np.int32))
    iv_lo = [int(x) for x in ivals_np[:, 0]]
    iv_hi = [int(x) for x in ivals_np[:, 1]]
    iv_sq = [int(x) for x in ivals_np[:, 2]]
    # per-seqidx base offsets/extents for the geometry stage
    nseq_s = int(max(iv_sq)) + 1
    offs_np = np.zeros(nseq_s + 1, np.int64)
    for lo_, hi_, sq_ in ivals_np:
        offs_np[int(sq_)] = lo_
        offs_np[int(sq_) + 1] = hi_
    offs_seq = jnp.asarray(offs_np.astype(np.int32))
    sq_arr = jnp.asarray(np.asarray(iv_sq, np.int32))
    ref_len_s = int(di.ref_len)
    # pass-1 window pad: windows wider than this re-stage on host
    # (the bench corpus' windows all fit 128 — the dp1 lane's sticky
    # scap never grew past it)
    SPAD = ((cfg.SPAD) + 127) // 128 * 128
    bsteps = int(np.ceil(np.log2(max(B, 2)))) + 1

    def _pool_geom_score(ref_alpha, rows_v, counts_v, fallback, codes,
                         qlens, sq_from_rows=False):
        """Shared tail: global pool compaction in per-read (strand,
        interval, emission) order, geometry (mc_calc_seg_offsets) +
        is_simd, and fused pass-1 window scoring.

        sq_from_rows: take each candidate's interval id from row
        field 6 (the combined-scan host_hits regime, where one slot
        carries every interval's candidates in interval order)
        instead of the V-loop slot index."""
        i32 = jnp.int32
        # ---- global pool compaction, (strand, interval, slot) order --
        rows_bs = jnp.stack(rows_v, axis=2)          # [B, 2, V, C, 7]
        cnts_bs = jnp.stack(counts_v, axis=2)        # [B, 2, V]
        S2 = 2 * V * C
        rows_flat = rows_bs.reshape(B, S2, 7)
        rev_slot = jnp.broadcast_to(
            jnp.arange(2, dtype=i32)[None, :, None, None],
            (B, 2, V, C)).reshape(B, S2)
        slot_ok = (jnp.arange(C, dtype=i32)[None, None, None, :] <
                   cnts_bs[:, :, :, None]).reshape(B, S2)
        counts2 = jnp.sum(cnts_bs, axis=2)           # [B, 2] F/R split
        read_counts = jnp.sum(counts2, axis=1)
        cum_read = jnp.cumsum(read_counts)           # inclusive
        npool = cum_read[-1]
        g_iota = jnp.arange(P, dtype=i32)
        lo = jnp.zeros((P,), i32)
        hi = jnp.full((P,), B, i32)
        for _ in range(bsteps):
            mid = (lo + hi) >> 1
            v_ = cum_read[jnp.clip(mid, 0, B - 1)]
            gohi = v_ <= g_iota
            lo = jnp.where(gohi, mid + 1, lo)
            hi = jnp.where(gohi, hi, mid)
        rd = jnp.minimum(lo, B - 1)
        within = g_iota - (cum_read[rd] - read_counts[rd])
        slot_sorted = jnp.sort(
            jnp.where(slot_ok, jnp.arange(S2, dtype=i32)[None, :], BIG),
            axis=1)
        fs = jnp.clip(slot_sorted[rd, jnp.minimum(within, S2 - 1)],
                      0, S2 - 1)
        pool_ok = g_iota < npool
        pool7 = jnp.where(pool_ok[:, None], rows_flat[rd, fs], 0)
        pool = pool7[:, :6]
        pool_rev = jnp.where(pool_ok, rev_slot[rd, fs], 0)
        if sq_from_rows:
            pool_sq = pool7[:, 6]
        else:
            sq_slot = jnp.broadcast_to(sq_arr[None, None, :, None],
                                       (B, 2, V, C)).reshape(B, S2)
            pool_sq = jnp.where(pool_ok, sq_slot[rd, fs], 0)
        pool_read = jnp.where(pool_ok, rd, 0)
        pool = pool.at[:, 5].set(pool[:, 5] | (pool_sq << 22))
        # reads whose rows spill past the pool cap fall back
        # individually (their pool slots are zero-padded; the host
        # skips flagged reads)
        fallback = fallback | (cum_read > P)

        # ---- geometry (mc_calc_seg_offsets) + is_simd + windows ----
        w0 = pool[:, 0]
        c_qs = w0 & 0xFF
        c_qe = (w0 >> 8) & 0xFF
        cover = (w0 >> 16) & 0xFF
        c_rs, c_re = pool[:, 1], pool[:, 2]
        shiftoffs = pool[:, 3]
        srange = pool[:, 5] & 0x3FFFFF
        qlen_p = qlens[pool_read]
        ro = offs_seq[jnp.clip(pool_sq, 0, nseq_s - 1)]
        rlen = offs_seq[jnp.clip(pool_sq, 0, nseq_s - 1) + 1] - ro
        rs_b = c_rs * nskip - ro
        re_b = c_re * nskip + (k - 1) - ro
        geom_ok = ((rs_b >= 0) & (re_b >= rs_b) & (re_b < rlen) &
                   (c_qe >= c_qs) & (c_qs < qlen_p))
        rev = pool_rev == 1
        qs_b = jnp.where(rev, qlen_p - c_qe - 1, c_qs)
        qe_b = jnp.where(rev, qlen_p - c_qs - 1, c_qe)
        edge = (qlen_p - cover) // EDGE_BAND_FACTOR
        edge = jnp.where(
            edge > nskip,
            jnp.minimum(edge, qlen_p >> MAX_BANDEDGE_2POW) - (nskip - 1),
            0)
        br = (-shiftoffs + 1) * nskip + edge + 1
        bl = br - (srange + 2) * nskip - 2 * edge - 2
        q_edge_l = qs_b
        q_edge_r = qlen_p - qe_b - 1
        qs2 = jnp.zeros_like(qs_b)            # qs - q_edge_l
        qe2 = qe_b + q_edge_r
        r_edge_l = q_edge_l + br
        r_edge_r = q_edge_r - bl
        hit_l = (r_edge_l > 0) & (rs_b < r_edge_l)
        r_edge_l2 = jnp.where(hit_l, rs_b, r_edge_l)
        rs2 = jnp.where(hit_l, 0, rs_b - r_edge_l)
        re2 = jnp.where(re_b + r_edge_r >= rlen, rlen - 1,
                        re_b + r_edge_r)
        geom_ok = geom_ok & (re2 >= rs2)
        band_offs = q_edge_l - r_edge_l2
        bl2 = bl + band_offs + qs2
        br2 = br + band_offs + qs2
        is_simd = (geom_ok & pool_ok &
                   (qlen_p >= MINLEN_QUERY_STRIPED) &
                   ((br2 - bl2) * BWSCAL_QLEN > qlen_p) &
                   (qs2 == 0) & (qe2 >= qlen_p - 1))
        slen = re2 - rs2 + 1
        fit = slen <= SPAD
        # NOTE: the host post block (fl_exact_post_block) and replay
        # (fl_pass1_replay g[11]) already accept a score of -2 as
        # "device declined an oversize SIMD window - host scores that
        # one row with the striped kernel"; emitting -2 here instead
        # of flagging the read is the next step once the other
        # fallback sources (pool cap / scan overflow) stop dominating
        # (r5 measured: restage counts invariant to this change).
        bad_geom = pool_ok & (~geom_ok | (is_simd & ~fit))
        fallback = fallback | \
            jnp.zeros((B,), bool).at[pool_read].max(bad_geom)

        # ---- pass-1 scoring of the SIMD-eligible pool rows ----
        do_sc = is_simd & fit
        gstart = ro + rs2
        slen_sc = jnp.where(do_sc, slen, 0)
        offs_i = jnp.arange(SPAD, dtype=i32)[None, :]
        gidx = jnp.clip(gstart[:, None] + offs_i, 0,
                        ref_alpha.shape[0] - 1)
        wins = jnp.where(offs_i >= slen_sc[:, None], 7, ref_alpha[gidx])
        reads32 = codes.astype(i32)
        j = jnp.arange(Q, dtype=i32)[None, :]
        src = qlens[:, None] - 1 - j
        gq = jnp.take_along_axis(reads32, jnp.maximum(src, 0), axis=1)
        rcq = jnp.where(src >= 0,
                        jnp.where((gq & 4) == 0, gq ^ 3, gq) & 7, 7)
        fwdq = jnp.where(j < qlens[:, None], reads32 & 7, 7)
        qcs = jnp.where(rev[:, None], rcq[pool_read], fwdq[pool_read])
        sc = sw_scores(qcs, wins, slen_sc, matrix, go, ge)
        scores = jnp.where(do_sc, sc, -1)
        return pool, counts2, scores, fallback

    @jax.jit
    def _step(table_pairs, pos, ref_alpha, codes, qbad, selmask, qlens,
              min_cover):
        i32 = jnp.int32
        is_seed, cnt, base = _hitinfo_device(jnp, cfg, codes, qbad,
                                             qlens, table_pairs)
        # checksum of the device's hit-info view, verified host-side:
        # {n_seeds, sum cnt*(t+1) mod 2^31}
        t1 = (jnp.arange(Q, dtype=i32) + 1)[None, None, :]
        cksum = jnp.stack(
            [jnp.sum(is_seed.astype(i32), axis=2),
             jnp.sum(jnp.where(is_seed, cnt * t1, 0), axis=2)
             & 0x7FFFFFFF], axis=2)                     # [B, 2, 2]

        sel = is_seed & (selmask > 0)
        selR = sel.reshape(R, Q)
        cntR = jnp.where(selR, cnt.reshape(R, Q), 0)
        baseR = base.reshape(R, Q)
        strand_is_rev = (jnp.arange(R, dtype=i32) % 2) == 1
        qlenR = jnp.repeat(qlens, 2)
        mincovR = jnp.repeat(min_cover, 2)
        mdsh = jnp.minimum(np.int32(k * SEG_DIFFSHIFT // nskip),
                           (qlenR - k) // nskip + 1)

        fallback = jnp.zeros((B,), bool)
        rows_v, counts_v = [], []
        for v in range(V):
            if V == 1 and iv_lo[v] == 0 and iv_hi[v] >= ref_len_s \
                    and nskip <= k:
                # the single interval spans every indexed position
                # (max tuple serial = (ref_len-k)//nskip < hi//nskip
                # when nskip <= wordlen): pos_range is the identity
                # slice, skipping 62 rounds of random pos gathers
                a, b = baseR, baseR + cntR
            else:
                a = _lower_bound(jnp, pos, baseR, baseR + cntR,
                                 np.int32(iv_lo[v] // nskip), 31)
                b = _lower_bound(jnp, pos, baseR, baseR + cntR,
                                 np.int32(iv_hi[v] // nskip), 31)
            nh = jnp.where(selR, b - a, 0)
            k1, k2, valid, total = _expand_hits(jnp, cfg, pos, a, nh,
                                                strand_is_rev)
            k1s, k2s = jax.lax.sort([k1, k2], num_keys=2)
            validS = jnp.arange(H, dtype=i32)[None, :] < total[:, None]
            ef, er, badscan = _segcand_scan(jax, jnp, cfg, k1s, k2s,
                                            validS, mdsh, mincovR,
                                            strand_is_rev)
            rows, counts, overC = _compact_rows(jax, jnp, cfg, ef, er)
            lane_bad = (total > H) | badscan | overC
            fallback = fallback | lane_bad.reshape(B, 2).any(axis=1)
            rows_v.append(rows.reshape(B, 2, C, 7))
            counts_v.append(counts.reshape(B, 2))

        pool, counts2, scores, fallback = _pool_geom_score(
            ref_alpha, rows_v, counts_v, fallback, codes, qlens)
        return pool, counts2, scores, cksum, fallback

    @jax.jit
    def _step_hh(ref_alpha, ks, k1, k2u8, tot, codes, qlens, min_cover):
        # host-expanded hits (fl_exact_pre_block): k1 [R,H] i32 packed
        # shift keys, k2u8 [R,H] u8 query offsets, tot [R] valid prefix
        # lengths, ks [R,H] i32 per-hit sequence ids (None when NS==1).
        # Sequential C writes replace the device's random pos[]
        # gathers.  With
        # NS > 1 the sort leads with ks, so the combined scan walks the
        # hits interval by interval exactly as the C engine's
        # seq-by-seq passes do (rmap.c SEQBYSEQ; mc_collect_segment
        # per ivals[v]), with forced breaks at the boundaries.
        i32 = jnp.int32
        strand_is_rev = (jnp.arange(R, dtype=i32) % 2) == 1
        qlenR = jnp.repeat(qlens, 2)
        mincovR = jnp.repeat(min_cover, 2)
        mdsh = jnp.minimum(np.int32(k * SEG_DIFFSHIFT // nskip),
                           (qlenR - k) // nskip + 1)
        h_iota = jnp.arange(H, dtype=i32)[None, :]
        valid = h_iota < tot[:, None]
        k1v = jnp.where(valid, k1, BIG)
        k2v = jnp.where(valid, k2u8.astype(i32), BIG)
        if ks is None:
            k1s, k2s = jax.lax.sort([k1v, k2v], num_keys=2)
            ivl = None
        else:
            ksv = jnp.where(valid, ks, BIG)
            ivl, k1s, k2s = jax.lax.sort([ksv, k1v, k2v], num_keys=3)
        ef, er, badscan = _segcand_scan(jax, jnp, cfg, k1s, k2s, valid,
                                        mdsh, mincovR, strand_is_rev,
                                        ivl=ivl)
        rows, counts, overC = _compact_rows(jax, jnp, cfg, ef, er)
        fallback = (badscan | overC).reshape(B, 2).any(axis=1)
        pool, counts2, scores, fallback = _pool_geom_score(
            ref_alpha, [rows.reshape(B, 2, C, 7)],
            [counts.reshape(B, 2)], fallback, codes, qlens,
            sq_from_rows=True)
        return pool, counts2, scores, fallback

    if cfg.host_hits:
        if not (V == 1 and nskip <= k and iv_lo[0] == 0
                and iv_hi[-1] >= ref_len_s
                and all(iv_lo[v + 1] == iv_hi[v]
                        for v in range(len(iv_lo) - 1))):
            raise ValueError("host_hits needs contiguous full-cover "
                             "intervals (seq-by-seq regime)")
        if cfg.NS > 1:
            def step(ks, k1, k2u8, tot, codes, qlens, min_cover):
                return _step_hh(ref_res, ks, k1, k2u8, tot, codes,
                                qlens, min_cover)
        else:
            def step(k1, k2u8, tot, codes, qlens, min_cover):
                return _step_hh(ref_res, None, k1, k2u8, tot, codes,
                                qlens, min_cover)

        return step

    def step(codes, qbad, selmask, qlens, min_cover):
        return _step(table_res, pos_res, ref_res, codes, qbad, selmask,
                     qlens, min_cover)

    return step
