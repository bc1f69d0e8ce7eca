"""Python side of the C fast-lane (native/fastlane.c).

The fast-lane maps a whole block of single-end reads to final SAM text
in one native call, replicating the exact Python path (rmap_single ->
add_single_to_report -> _write_sam) byte-for-byte.  `FastLane.make`
gates on the modes the lane covers; `render_block` returns None on any
native-side error, in which case the caller reruns the block through
the Python engine with the untouched RNG state (the lane commits the
drand48 state only on success).
"""
from __future__ import annotations

from typing import Optional

import os

import numpy as np

from .. import rand
from ..align import core as ali_mod
from ..native import get_lib
from ..results import pairs as pairs_mod
from . import engine as eng_mod


class FastLane:
    def __init__(self, engine, soft_clip: bool, x_mismatch: bool,
                 out_fmt: int = 0, ali_out: bool = False):
        lib = get_lib()
        p = engine.params
        refset = engine.refset
        idx = engine.index
        self.lib = lib
        self.engine = engine
        self.soft_clip = soft_clip
        self.x_mismatch = x_mismatch
        self.out_fmt = out_fmt       # 0 SAM, 1 cigar, 2 ssaha, 3 gff
        self.ali_out = ali_out       # -a explicit alignment display
        # pinned argument buffers
        self._matrix = np.ascontiguousarray(engine.matrix, dtype=np.int32)
        self._ivals = np.ascontiguousarray(engine._seq_ivals, dtype=np.int64)
        snames = []
        offs = [0]
        for s in range(refset.nseq):
            snames.append(refset.sam_name(s).encode())
            offs.append(offs[-1] + len(snames[-1]))
        self._snames = np.frombuffer(b"".join(snames) or b"\0",
                                     dtype=np.uint8).copy()
        self._sname_offs = np.asarray(offs, dtype=np.int64)
        self._offsets = np.ascontiguousarray(refset.offsets, np.int64)
        self._refcodes = np.ascontiguousarray(refset.codes, np.uint8)
        ma, mm = ali_mod.avg_penalties(engine.matrix)
        self._avgs = (ma, mm)
        wa, sa, pa, ta = idx.addrs
        self._idx_addrs = (wa, sa, idx.nwords, ta, pa)
        self._rng_io = np.zeros(1, dtype=np.uint64)

    @classmethod
    def make(cls, engine, fmt: str, soft_clip: bool, x_mismatch: bool,
             ali_out: bool, fix_primary: bool) -> Optional["FastLane"]:
        """Return a lane when the run's modes are covered, else None."""
        lib = get_lib()
        if lib is None or not hasattr(lib, "fl_map_block"):
            return None
        if fmt not in ("sam", "cigar", "ssaha", "gff"):
            return None
        # -a (explicit alignment display) emits via tx_align_display
        # fix_primary (set for -d runs on sam/bam) replays
        # reportFixMultiplePrimary, which only clears the PRIMARY
        # status bit — no writer consumes it (SAM NOTPRIMARY derives
        # from PARTIAL), so the lane's output is unaffected; goldens
        # golden_se_r1_d5/dm1 pin this.
        p = engine.params
        # -d (scorediff) clears RMAPFLG_BEST / RESULTFLG_SINGLE: the C
        # report stage replicates the non-BEST multi-report walk and
        # BELOWRELSW filtering (fl_add_single_to_report, rs_filter).
        # Both reference regimes run natively: seq-by-seq (< 512
        # sequences) and whole-genome cutoff collection with post-pass
        # sequence assignment (>= 512; boundary-spanning alignments
        # fall back per block/pair for splitMultiSpan).
        return cls(engine, soft_clip, x_mismatch,
                   out_fmt={"sam": 0, "cigar": 1, "ssaha": 2,
                            "gff": 3}[fmt],
                   ali_out=ali_out)

    def render_block(self, block) -> Optional[str]:
        """One native call for a block of Read objects."""
        n = len(block)
        read_offs = np.zeros(n + 1, dtype=np.int64)
        name_offs = np.zeros(n + 1, dtype=np.int64)
        has_qual = np.zeros(n, dtype=np.uint8)
        codes_parts = []
        qual_parts = []
        name_parts = []
        qmax = 1
        for i, read in enumerate(block):
            seq = read.seq
            if seq.dtype != np.uint8 or not seq.flags.c_contiguous:
                seq = np.ascontiguousarray(seq, dtype=np.uint8)
            codes_parts.append(seq)
            ql = len(seq)
            qmax = max(qmax, ql)
            if read.qual is not None:
                if len(read.qual) != ql:
                    return None
                qual_parts.append(read.qual)
                has_qual[i] = 1
            else:
                qual_parts.append(b"\x00" * ql)
            nm = read.name.encode()     # raw: the C side applies the
            name_parts.append(nm)       # format's own name cut
            read_offs[i + 1] = read_offs[i] + ql
            name_offs[i + 1] = name_offs[i] + len(nm)
        codes = np.concatenate(codes_parts) if codes_parts else \
            np.zeros(1, np.uint8)
        quals = np.frombuffer(b"".join(qual_parts) or b"\0", np.uint8)
        names = np.frombuffer(b"".join(name_parts) or b"\0", np.uint8)
        return self._call(n, qmax, codes, read_offs, quals, has_qual,
                          names, name_offs, ascii_codes=False,
                          names_raw=True)

    def render_raw_block(self, names, seqs, quals) -> Optional[str]:
        """One native call for raw bulk-reader output (bytes lists):
        encode + name-strip happen in C."""
        n = len(names)
        read_offs = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(s) for s in seqs], out=read_offs[1:])
        name_offs = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(x) for x in names], out=name_offs[1:])
        qmax = int((read_offs[1:] - read_offs[:-1]).max()) if n else 1
        has_qual = np.empty(n, dtype=np.uint8)
        qual_parts = []
        for i, q in enumerate(quals):
            if q is not None:
                if len(q) != len(seqs[i]):
                    return None     # malformed record: exact reader decides
                has_qual[i] = 1
                qual_parts.append(q)
            else:
                has_qual[i] = 0
                qual_parts.append(b"\x00" * len(seqs[i]))
        codes = np.frombuffer(b"".join(seqs) or b"\0", np.uint8)
        qarr = np.frombuffer(b"".join(qual_parts) or b"\0", np.uint8)
        narr = np.frombuffer(b"".join(names) or b"\0", np.uint8)
        return self._call(n, max(qmax, 1), codes, read_offs, qarr, has_qual,
                          narr, name_offs, ascii_codes=True, names_raw=True)

    def _call(self, n, qmax, codes, read_offs, quals, has_qual,
              names, name_offs, ascii_codes: bool,
              names_raw: bool) -> Optional[str]:
        p = self.engine.params
        filt = self.engine.filter
        wa, sa, nwords, ta, pa = self._idx_addrs
        idx = self.engine.index
        cap = int(name_offs[-1]) + n * (2 * qmax + 192)
        self._rng_io[0] = rand._global._x
        for _ in range(3):
            out = np.empty(cap, dtype=np.uint8)
            rc = self.lib.fl_map_block(
                wa, sa, nwords, ta, pa, idx.wordlen, idx.nskip,
                self._refcodes.ctypes.data, self._offsets.ctypes.data,
                self.engine.refset.nseq, self._ivals.ctypes.data,
                self._snames.ctypes.data, self._sname_offs.ctypes.data,
                self._matrix.ctypes.data,
                -self.engine.gapopen, -self.engine.gapext,
                self._avgs[0], self._avgs[1],
                p.ktuple_maxhit, eng_mod.HASH_MAXNHITS,
                p.min_cover_frac, p.min_swatscor,
                p.min_swatscor_below_max, p.min_basq,
                p.target_depth, p.max_depth,
                p.rmapflg & ~eng_mod.RMAPFLG_ALLPAIR, p.rsltouflg,
                filt.min_swscor, filt.min_swscor_below_max,
                filt.min_identity,
                1 if self.soft_clip else 0, 1 if self.x_mismatch else 0,
                self.out_fmt, 1 if self.ali_out else 0,
                1 if ascii_codes else 0, 1 if names_raw else 0,
                n, codes.ctypes.data, read_offs.ctypes.data,
                quals.ctypes.data, has_qual.ctypes.data,
                names.ctypes.data, name_offs.ctypes.data,
                self._rng_io.ctypes.data, out.ctypes.data, cap,
                float(self.engine.lam))
            if rc == -3:          # text buffer too small: grow and retry
                cap *= 4
                continue
            if rc < 0:
                self.last_rc = rc          # debugging/observability
                return None
            rand._global._x = int(self._rng_io[0])
            return out[:rc].tobytes().decode("ascii")
        return None


class PairLane:
    """Exact paired-end C lane: a whole block of read pairs maps and
    renders in ONE native call (fl_map_pair_block — the rmapPair
    common flow, rmap.c:1744-2112, plus the full pair layer,
    resultpairs.c:753-1311).  A pair hitting an uncovered branch
    (remap/rescue/fine-rehash, caps) stops the native call cleanly
    with nothing consumed for that pair; the caller replays exactly
    that pair through the Python oracle and resumes, so output is
    byte-identical to the pure-Python path for any mix."""

    def __init__(self, lane: FastLane, insert_min: int, insert_max: int,
                 pairtyp: int, ihist=None):
        self.lane = lane
        self.insert_min = insert_min
        self.insert_max = insert_max
        self.pairtyp = pairtyp
        # -g: precompute the inclusive cumulative bin counts the C
        # probability model looks up (insGetHistoCountCumulative,
        # insert.py:81-86); smooth counts when smoothing ran
        if ihist is not None:
            arr = ihist.smooth if ihist.smoothed else ihist.counts
            self._ih_cum = np.cumsum(np.asarray(arr, dtype=np.int64))
            self._ih_desc = (int(ihist.span), int(ihist.insizlo),
                             int(ihist.insizhi), int(ihist.scalfac),
                             int(ihist.num))
        else:
            self._ih_cum = None
            self._ih_desc = (0, 0, 0, 1, 0)

    @classmethod
    def make(cls, engine, fmt, soft_clip, x_mismatch, ali_out,
             fix_primary, ihist) -> Optional["PairLane"]:
        lane = FastLane.make(engine, fmt, soft_clip, x_mismatch, ali_out,
                             fix_primary)
        if lane is None:
            return None
        # paired -d: the reference supports only -d 0 for pairs
        # (map -H), i.e. RESULTFLG_BEST with SINGLE/RANDSEL cleared —
        # the pair report walk handles it (test_pair_lane d0 case);
        # anything without BEST keeps the Python oracle
        if not (engine.params.rsltouflg & pairs_mod.RESULTFLG_BEST):
            return None
        # paired split-read mode (-p): fl_map_pair runs the
        # mapSecondary pass on both mates and the report adds the
        # per-segment PARTIAL chain (flrep_add_2ndary), reference-
        # diffed in tests/test_ref_differential.py (pe -p)
        if not hasattr(lane.lib, "fl_map_pair_block"):
            return None
        p = engine.params
        return cls(lane, p.insert_min, p.insert_max, p.pairtyp, ihist)

    def _arrays(self, reads):
        n = len(reads)
        offs = np.zeros(n + 1, dtype=np.int64)
        name_offs = np.zeros(n + 1, dtype=np.int64)
        has_qual = np.zeros(n, dtype=np.uint8)
        codes_parts, qual_parts, name_parts = [], [], []
        for i, rd in enumerate(reads):
            seq = rd.seq
            if seq.dtype != np.uint8 or not seq.flags.c_contiguous:
                seq = np.ascontiguousarray(seq, dtype=np.uint8)
            codes_parts.append(seq)
            ql = len(seq)
            if rd.qual is not None:
                if len(rd.qual) != ql:
                    return None
                qual_parts.append(rd.qual)
                has_qual[i] = 1
            else:
                qual_parts.append(b"\x00" * ql)
            if self.lane.out_fmt == 0:
                nm = rd.sam_name.encode()           # SAM: /1 /2 stripped
            else:
                # cigar/ssaha qname keeps /1 /2 (report.py _qname)
                nm = (rd.name.split()[0] if rd.name else "").encode()
            name_parts.append(nm)
            offs[i + 1] = offs[i] + ql
            name_offs[i + 1] = name_offs[i] + len(nm)
        codes = np.concatenate(codes_parts) if codes_parts else \
            np.zeros(1, np.uint8)
        quals = np.frombuffer(b"".join(qual_parts) or b"\0", np.uint8)
        names = np.frombuffer(b"".join(name_parts) or b"\0", np.uint8)
        return codes, offs, quals, has_qual, names, name_offs

    @staticmethod
    def _raw_arrays(names, seqs, quals):
        """Concat arrays straight from bulk-reader bytes (no Read
        objects); encode + name cutting happen in C."""
        n = len(names)
        offs = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(s) for s in seqs], out=offs[1:])
        name_offs = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(x) for x in names], out=name_offs[1:])
        has_qual = np.empty(n, dtype=np.uint8)
        qual_parts = []
        for i, q in enumerate(quals):
            if q is not None:
                if len(q) != len(seqs[i]):
                    return None    # malformed record: exact reader decides
                has_qual[i] = 1
                qual_parts.append(q)
            else:
                has_qual[i] = 0
                qual_parts.append(b"\x00" * len(seqs[i]))
        codes = np.frombuffer(b"".join(seqs) or b"\0", np.uint8)
        qarr = np.frombuffer(b"".join(qual_parts) or b"\0", np.uint8)
        narr = np.frombuffer(b"".join(names) or b"\0", np.uint8)
        return codes, offs, qarr, has_qual, narr, name_offs

    def _call(self, readsA, readsB):
        """(text, n_done) for the leading pairs the C lane covered, or
        None on a hard error (caller renders the block in Python)."""
        arrA = self._arrays(readsA)
        arrB = self._arrays(readsB)
        if arrA is None or arrB is None:
            return None
        return self._call_arrays(len(readsA), arrA, arrB,
                                 ascii_codes=False, names_raw=False)

    def _call_raw(self, namesA, seqsA, qualsA, namesB, seqsB, qualsB):
        arrA = self._raw_arrays(namesA, seqsA, qualsA)
        arrB = self._raw_arrays(namesB, seqsB, qualsB)
        if arrA is None or arrB is None:
            return None
        return self._call_arrays(len(namesA), arrA, arrB,
                                 ascii_codes=True, names_raw=True)

    def _call_arrays(self, n, arrA, arrB, ascii_codes, names_raw,
                     dev=None):
        """dev (optional): (state, offs_A, offs_B, scores64) — the
        device-exact front half's per-mate state; the C block then
        consumes it for the pair flow's unrestricted mapping calls
        (fl_pair_map_single_dev) and keeps everything else on host."""
        lane = self.lane
        eng = lane.engine
        p = eng.params
        filt = eng.filter
        wa, sa, nwords, ta, pa = lane._idx_addrs
        idx = eng.index
        cA, oA, qA, hA, nA, noA = arrA
        cB, oB, qB, hB, nB, noB = arrB
        if n < 1:
            return "", 0
        if dev is not None:
            dstate, doffA, doffB, dscores = dev
            dev_args = (dstate.ctypes.data, doffA.ctypes.data,
                        doffB.ctypes.data, dscores.ctypes.data,
                        len(dscores))
        else:
            dev_args = (None, None, None, None, 0)
        qmax = int(max((oA[1:] - oA[:-1]).max(),
                       (oB[1:] - oB[:-1]).max(), 1))
        cap = int(noA[-1] + noB[-1]) + 2 * n * (2 * qmax + 224)
        done = np.zeros(1, dtype=np.int64)
        lane._rng_io[0] = rand._global._x
        for _ in range(3):
            out = np.empty(cap, dtype=np.uint8)
            rc = lane.lib.fl_map_pair_block(
                wa, sa, nwords, ta, pa, idx.wordlen, idx.nskip,
                lane._refcodes.ctypes.data, lane._offsets.ctypes.data,
                eng.refset.nseq, lane._ivals.ctypes.data,
                lane._snames.ctypes.data, lane._sname_offs.ctypes.data,
                lane._matrix.ctypes.data,
                -eng.gapopen, -eng.gapext,
                lane._avgs[0], lane._avgs[1],
                p.ktuple_maxhit, eng_mod.HASH_MAXNHITS,
                p.min_cover_frac, p.min_swatscor,
                p.min_swatscor_below_max, p.min_basq,
                p.target_depth, p.max_depth,
                p.rmapflg, p.rsltouflg,
                filt.min_swscor, filt.min_swscor_below_max,
                filt.min_identity,
                1 if lane.soft_clip else 0, 1 if lane.x_mismatch else 0,
                lane.out_fmt, 1 if lane.ali_out else 0,
                self.insert_min, self.insert_max, self.pairtyp,
                self._ih_cum.ctypes.data if self._ih_cum is not None
                else None, *self._ih_desc,
                1 if ascii_codes else 0, 1 if names_raw else 0,
                n, cA.ctypes.data, oA.ctypes.data,
                qA.ctypes.data, hA.ctypes.data,
                nA.ctypes.data, noA.ctypes.data,
                cB.ctypes.data, oB.ctypes.data,
                qB.ctypes.data, hB.ctypes.data,
                nB.ctypes.data, noB.ctypes.data,
                lane._rng_io.ctypes.data, out.ctypes.data, cap,
                done.ctypes.data, float(eng.lam), *dev_args)
            if rc == -3:                   # text buffer too small
                cap *= 4
                continue
            if rc < 0:
                return None
            rand._global._x = int(lane._rng_io[0])
            return out[:rc].tobytes().decode("ascii"), int(done[0])
        return None

    def render_block(self, block, oracle_one) -> Optional[str]:
        """SAM text for a block of (read, mate) tuples.  `oracle_one`
        renders a single pair through the Python engine (consuming its
        own RNG) — called only for pairs the C flow does not cover."""
        parts = []
        start = 0
        n = len(block)
        while start < n:
            readsA = [it[0] for it in block[start:]]
            readsB = [it[1] for it in block[start:]]
            res = self._call(readsA, readsB)
            if res is None:
                if start == 0:
                    return None        # whole block to the Python path
                # render the remainder in Python (RNG stream continuous)
                for it in block[start:]:
                    parts.append(oracle_one(it))
                return "".join(parts)
            text, ndone = res
            parts.append(text)
            start += ndone
            if start < n:
                parts.append(oracle_one(block[start]))
                start += 1
        return "".join(parts)

    def render_raw_pairs(self, namesA, seqsA, qualsA,
                         namesB, seqsB, qualsB,
                         oracle_one_raw) -> Optional[str]:
        """Same per-pair resume protocol as render_block, but fed
        straight from bulk-reader bytes (encode + name cutting in C);
        `oracle_one_raw(i)` renders pair i through the Python engine."""
        parts = []
        start = 0
        n = len(namesA)
        while start < n:
            res = self._call_raw(namesA[start:], seqsA[start:],
                                 qualsA[start:], namesB[start:],
                                 seqsB[start:], qualsB[start:])
            if res is None:
                if start == 0:
                    return None       # whole batch to the Python path
                for i in range(start, n):
                    parts.append(oracle_one_raw(i))
                return "".join(parts)
            text, ndone = res
            parts.append(text)
            start += ndone
            if start < n:
                parts.append(oracle_one_raw(start))
                start += 1
        return "".join(parts)


class DevicePass1:
    """Device-assisted exact mapping: the device scores the pass-1
    full-matrix candidate windows (the reference's SIMD kernel slot,
    scoreRMAPCAND rmap.c:588-788 / swsimd.c:868-934) for whole batches
    while the host C lane does seeding/collation and the exact pass-2.
    Output is byte-identical to the host lane: the device scorer
    (ops/sw.py) computes the same integer scores as sw_full, and the
    phase-B replay reproduces the early-break logic on the precomputed
    score stream.

    Batches pipeline: phase A (host) -> async device dispatch ->
    phase B (host) runs one batch behind, so device time overlaps the
    host tail."""

    def __init__(self, lane: FastLane, batch: int = 0):
        import os
        self.lane = lane
        self.batch = batch or int(os.environ.get("SMALT_DP1_BATCH", 8192))
        eng = lane.engine
        if -eng.gapopen < -eng.gapext:
            raise ValueError("device scorer needs gapopen >= gapext")
        self._ref_alpha = None  # built lazily (refcodes & 7)
        # sticky shape caps: every device call is padded to (batch, qcap)
        # reads / wcap windows so the whole run compiles exactly once
        self._qcap = 128
        self._scap = 128
        self._wcap = 4 * self.batch

    @classmethod
    def make(cls, engine, fmt, soft_clip, x_mismatch, ali_out, fix_primary,
             batch: int = 0) -> Optional["DevicePass1"]:
        lane = FastLane.make(engine, fmt, soft_clip, x_mismatch, ali_out,
                             fix_primary)
        if lane is None:
            return None
        if engine.params.rmapflg & (eng_mod.RMAPFLG_SPLIT |
                                    eng_mod.RMAPFLG_NOSHRTINFO):
            # the two-phase block drivers (fl_pass1/2_block) have no
            # mapSecondary pass; -p runs through the one-phase C lane
            return None
        if not (engine.params.rmapflg & eng_mod.RMAPFLG_SEQBYSEQ):
            # fl_pass1/2_block drive seq-by-seq collection only; the
            # >= 512-sequence regime runs the one-phase C lane
            return None
        if -engine.gapopen < -engine.gapext:
            return None
        return cls(lane, batch=batch)

    # ---------------- phase A ----------------

    def _pass1(self, n, qmax, codes, read_offs, quals, has_qual,
               ascii_codes: bool):
        lane = self.lane
        p = lane.engine.params
        wa, sa, nwords, ta, pa = lane._idx_addrs
        idx = lane.engine.index
        state_cap = n * (8 + 64 * 12) + 4096
        win_cap = n * 8 + 64
        for _ in range(4):
            state = np.empty(state_cap, dtype=np.int64)
            state_offs = np.empty(n + 1, dtype=np.int64)
            win_desc = np.empty(win_cap * 4, dtype=np.int64)
            rc = lane.lib.fl_pass1_block(
                wa, sa, nwords, ta, pa, idx.wordlen, idx.nskip,
                lane._refcodes.ctypes.data, lane._offsets.ctypes.data,
                lane.engine.refset.nseq, lane._ivals.ctypes.data,
                lane._matrix.ctypes.data,
                -lane.engine.gapopen, -lane.engine.gapext,
                lane._avgs[0], lane._avgs[1],
                p.ktuple_maxhit, eng_mod.HASH_MAXNHITS,
                p.min_cover_frac, p.min_swatscor,
                p.min_swatscor_below_max, p.min_basq,
                p.target_depth, p.max_depth,
                p.rmapflg & ~eng_mod.RMAPFLG_ALLPAIR,
                1 if ascii_codes else 0,
                n, codes.ctypes.data, read_offs.ctypes.data,
                quals.ctypes.data, has_qual.ctypes.data,
                state.ctypes.data, state_cap, state_offs.ctypes.data,
                win_desc.ctypes.data, win_cap)
            if rc == -1:           # capacity: grow and retry
                state_cap *= 4
                win_cap *= 4
                continue
            if rc < 0:
                return None
            return state, state_offs, win_desc[: int(rc) * 4].reshape(-1, 4)
        return None

    # ---------------- device scoring ----------------

    def _padded_reads(self, codes, read_offs, n, qmax):
        """([batch, qcap] 3-bit codes padded with 7, [batch] int32
        lengths) — always the sticky fixed shape, so the jit compiles
        once for the whole run (trailing partial batches included)."""
        while self._qcap < qmax:
            self._qcap *= 2
        fwd = np.full((self.batch, self._qcap), 7, np.uint8)
        al = codes & 7
        qlens = np.zeros(self.batch, np.int32)
        qlens[:n] = (read_offs[1:] - read_offs[:-1]).astype(np.int32)
        if n and qlens[0] and (qlens[:n] == qlens[0]).all():
            L = int(qlens[0])
            fwd[:n, :L] = al[: n * L].reshape(n, L)
        else:
            for i in range(n):
                o, e = int(read_offs[i]), int(read_offs[i + 1])
                fwd[i, : e - o] = al[o:e]
        return fwd, qlens

    def _device_fn(self):
        """Jitted device stage: the REFERENCE stays device-resident and
        windows are gathered on the device — only read codes (uint8)
        and the per-window descriptors cross the host link.  The scorer
        (ops/sw.py sw_scores) produces scores identical to the host
        sw_full kernel.

        The jit is cached at module level keyed by (matrix, penalties):
        separate DevicePass1 instances (every CLI run builds
        one) share the trace and the compiled executable instead of
        re-tracing per instance (the r3 bench paid a full re-trace +
        compile on the measured run because the warm run used its own
        instance)."""
        fn = getattr(self, "_dev_jit", None)
        if fn is not None:
            return fn
        eng = self.lane.engine
        matrix = np.asarray(eng.matrix, np.int32)
        go, ge = -eng.gapopen, -eng.gapext
        self._dev_jit = _dp1_step_fn(matrix.tobytes(), matrix.shape,
                                     go, ge)
        return self._dev_jit

    def _score_windows(self, win_desc, fwd, qlens):
        """Dispatch one batch of windows; returns (jax array, nw) with
        the D2H fetch started (async) — the caller slices [:nw] after
        np.asarray, on the host."""
        import jax
        lane = self.lane
        if self._ref_alpha is None:
            # resident device copy of the reference (alpha codes, uint8)
            self._ref_alpha = jax.device_put(
                (lane._refcodes & 7).astype(np.uint8))
        nw = len(win_desc)
        # pad S to a 128 multiple and the window count to the sticky cap
        # (padded windows have slens 0: every row masked, score 0) —
        # with the fixed read batch this keeps the run to ONE compile
        S = int(win_desc[:, 1].max()) if nw else 128
        while self._scap < S:
            self._scap *= 2
        S = self._scap
        while self._wcap < nw:
            self._wcap *= 2
        wd = np.zeros((self._wcap, 4), dtype=np.int32)
        wd[:nw] = win_desc
        out = self._device_fn()(self._ref_alpha, fwd, qlens, wd, S)
        try:
            out.copy_to_host_async()   # overlap D2H with the host tail
        except AttributeError:
            pass
        return out, nw

    # ---------------- phase B ----------------

    def _pass2(self, n, qmax, codes, read_offs, quals, has_qual,
               names, name_offs, state, state_offs, scores,
               ascii_codes: bool, names_raw: bool,
               dev=None) -> Optional[str]:
        """dev: (pres, phdr, best, mi, mj, rec16, valid, sp, nwin)
        from the device pass-2 dispatch (exact_pass2.py), or None for
        the host pass-2."""
        lane = self.lane
        p = lane.engine.params
        filt = lane.engine.filter
        wa, sa, nwords, ta, pa = lane._idx_addrs
        idx = lane.engine.index
        scores64 = np.ascontiguousarray(scores, dtype=np.int64)
        cap = int(name_offs[-1]) + n * (2 * qmax + 192)
        lane._rng_io[0] = rand._global._x
        if dev is not None:
            pres, phdr, dbest, dmi, dmj, drec, dvalid, dsp, dnwin = dev
            self._dev_stats = np.zeros(3, np.int64)
            if os.environ.get("SMALT_DX_P2") == "prep":
                # bisect mode: prep-replay consume only, host decode
                dev_args = (pres.ctypes.data, phdr.ctypes.data,
                            None, None, None, None, None, 0, 0,
                            self._dev_stats.ctypes.data)
            else:
                dev_args = (pres.ctypes.data, phdr.ctypes.data,
                            dbest.ctypes.data, dmi.ctypes.data,
                            dmj.ctypes.data, drec.ctypes.data,
                            dvalid.ctypes.data, int(dsp), int(dnwin),
                            self._dev_stats.ctypes.data)
        else:
            dev_args = (None,) * 2 + (None,) * 5 + (0, 0, None)
        for _ in range(3):
            out = np.empty(cap, dtype=np.uint8)
            rc = lane.lib.fl_pass2_block(
                wa, sa, nwords, ta, pa, idx.wordlen, idx.nskip,
                lane._refcodes.ctypes.data, lane._offsets.ctypes.data,
                lane.engine.refset.nseq, lane._ivals.ctypes.data,
                lane._snames.ctypes.data, lane._sname_offs.ctypes.data,
                lane._matrix.ctypes.data,
                -lane.engine.gapopen, -lane.engine.gapext,
                lane._avgs[0], lane._avgs[1],
                p.ktuple_maxhit, eng_mod.HASH_MAXNHITS,
                p.min_cover_frac, p.min_swatscor,
                p.min_swatscor_below_max, p.min_basq,
                p.target_depth, p.max_depth,
                p.rmapflg & ~eng_mod.RMAPFLG_ALLPAIR, p.rsltouflg,
                filt.min_swscor, filt.min_swscor_below_max,
                filt.min_identity,
                1 if lane.soft_clip else 0, 1 if lane.x_mismatch else 0,
                lane.out_fmt, 1 if lane.ali_out else 0,
                1 if ascii_codes else 0, 1 if names_raw else 0,
                n, codes.ctypes.data, read_offs.ctypes.data,
                quals.ctypes.data, has_qual.ctypes.data,
                names.ctypes.data, name_offs.ctypes.data,
                state.ctypes.data, state_offs.ctypes.data,
                scores64.ctypes.data, len(scores64),
                lane._rng_io.ctypes.data, out.ctypes.data, cap,
                float(lane.engine.lam), *dev_args)
            if os.environ.get("SMALT_DX_DEBUG"):
                import sys as _s
                print(f"# fl_pass2_block rc={rc} n={n} dev={dev is not None}",
                      file=_s.stderr, flush=True)
            if rc == -3:
                cap *= 4
                continue
            if rc < 0:
                return None
            rand._global._x = int(lane._rng_io[0])
            return out[:rc].tobytes().decode("ascii")
        return None

    # ---------------- driver ----------------

    def run_raw_fastq(self, path: str, out, fallback) -> None:
        """Map a FASTQ file: bulk parse -> phase A -> device -> phase B.
        The whole device leg (pad + H2D + dispatch + D2H) runs on a
        worker thread so transfers and device compute hide behind the
        host C work of the neighbouring batches.  `fallback(names,
        seqs, quals)` renders a batch
        through the host lane when any native stage errors (no RNG
        consumed by then)."""
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor
        from .fastmode import iter_fastq_batches

        import os
        import sys
        import time
        timing = bool(os.environ.get("SMALT_DP1_TIMING"))
        pending = deque()
        pool = ThreadPoolExecutor(max_workers=1)

        def device_leg(win_desc, fwd, qlens):
            if timing:
                t0 = time.time()
                scores, nw = self._score_windows(win_desc, fwd, qlens)
                t1 = time.time()
                scores.block_until_ready()
                t2 = time.time()
                sc = np.asarray(scores)[:nw]
                print(f"# dp1-dev nw={nw} call={t1-t0:.3f} "
                      f"wait={t2-t1:.3f} fetch={time.time()-t2:.3f}",
                      file=sys.stderr, flush=True)
                return sc
            scores, nw = self._score_windows(win_desc, fwd, qlens)
            return np.asarray(scores)[:nw]

        def prepare(names, seqs, quals):
            t0 = time.time() if timing else 0
            n = len(names)
            read_offs = np.zeros(n + 1, dtype=np.int64)
            np.cumsum([len(s) for s in seqs], out=read_offs[1:])
            name_offs = np.zeros(n + 1, dtype=np.int64)
            np.cumsum([len(x) for x in names], out=name_offs[1:])
            qmax = int((read_offs[1:] - read_offs[:-1]).max()) if n else 1
            has_qual = np.empty(n, dtype=np.uint8)
            qp = []
            for i, q in enumerate(quals):
                if q is not None and len(q) == len(seqs[i]):
                    has_qual[i] = 1
                    qp.append(q)
                else:
                    return None
            codes = np.frombuffer(b"".join(seqs) or b"\0", np.uint8)
            qarr = np.frombuffer(b"".join(qp) or b"\0", np.uint8)
            narr = np.frombuffer(b"".join(names) or b"\0", np.uint8)
            st = self._pass1(n, qmax, codes, read_offs, qarr, has_qual,
                             ascii_codes=True)
            if st is None:
                return None
            state, state_offs, win_desc = st
            if len(win_desc):
                fwd, qlens = self._padded_reads(
                    np.frombuffer(codec_encode_bulk(codes), np.uint8),
                    read_offs, n, qmax)
                scores = pool.submit(device_leg, win_desc, fwd, qlens)
            else:
                scores = None
            return (n, qmax, codes, read_offs, qarr, has_qual, narr,
                    name_offs, state, state_offs, scores)

        def finish(item, raw):
            (n, qmax, codes, read_offs, qarr, has_qual, narr, name_offs,
             state, state_offs, scores) = item
            try:
                if timing:
                    t0 = time.time()
                    sc = (scores.result() if scores is not None
                          else np.zeros(0, np.int32))
                    print(f"# dp1-main stall={time.time()-t0:.3f}",
                          file=sys.stderr, flush=True)
                else:
                    sc = (scores.result() if scores is not None
                          else np.zeros(0, np.int32))
            except Exception:      # device-leg failure: host fallback
                return fallback(*raw)
            text = self._pass2(n, qmax, codes, read_offs, qarr, has_qual,
                               narr, name_offs, state, state_offs,
                               sc, ascii_codes=True, names_raw=True)
            if text is None:
                text = fallback(*raw)
            return text

        try:
            for raw in iter_fastq_batches(path, self.batch):
                item = prepare(*raw)
                if item is None:
                    out.write(fallback(*raw))
                    continue
                pending.append((item, raw))
                while len(pending) > 2:
                    out.write(finish(*pending.popleft()))
            while pending:
                out.write(finish(*pending.popleft()))
        finally:
            pool.shutdown(wait=True)


class DeviceExact(DevicePass1):
    """Device-exact mapping: the chip carries the exact engine's FRONT
    HALF — seeding, hit collection, shift-sort, segment/candidate
    collation AND pass-1 window scoring — in one dispatch per block
    (parallel/exact_collate.py), while the host keeps only hit-info
    rank selection, the NR depth sort, pass 2 and rendering.  Output
    stays byte-identical to the pure-C lane: any read the device
    cannot serve exactly (capacity overflow, checksum or geometry
    mismatch) is re-staged fully on host by fl_pass2_block.

    This is the round-4 answer to the Amdahl cap on --device-pass1:
    pass-1 SW alone is ~28% of exact-lane time; seed+collate+pass-1
    together are ~51% (SMALT_FL_TIMING split), so the ceiling moves
    from ~1.4x to ~2x per host core with the chip absorbing the front
    half behind the host tail."""

    QMAX = 255          # packed row fields gate (cover/qs/qe <= 255)

    def __init__(self, lane: FastLane, batch: int = 0):
        import os
        super().__init__(lane, batch=batch or
                         int(os.environ.get("SMALT_DX_BATCH", 4096)))
        self._collate = None
        self._di = None
        self._qcap = 128
        # device pass-2 (exact_pass2.py): sticky caps so the whole run
        # compiles once.  OFF by default (SMALT_DX_P2=1 opts in): it is
        # byte-exact, but no measurement shows it beating the host
        # pass 2 end to end
        self._p2_on = os.environ.get("SMALT_DX_P2", "0") == "1"
        self._p2_wcap = 512
        self._p2_sp = 2 * self._qcap
        self._p2_fn = None
        self.p2_used = 0
        self.p2_fb = 0
        self.p2_hit = 0

    @classmethod
    def make(cls, engine, fmt, soft_clip, x_mismatch, ali_out,
             fix_primary, batch: int = 0) -> Optional["DeviceExact"]:
        base = DevicePass1.make(engine, fmt, soft_clip, x_mismatch,
                                ali_out, fix_primary, batch=batch)
        if base is None:
            return None
        lane = base.lane
        lib = lane.lib
        if not hasattr(lib, "fl_exact_pre_block"):
            return None
        idx = engine.index
        if engine.refset.total_len >= (1 << 31):
            return None                 # int32 serial/base coords gate
        if not cls._host_hits_ok(engine):
            # device-side hit expansion: direct-address table + the
            # static interval loop (the pre-host_hits regime)
            if 2 * idx.wordlen > 28:
                return None
            if engine.refset.nseq > 8:
                return None
        return cls(lane, batch=batch)

    # ---------------- device function ----------------

    @staticmethod
    def _host_hits_ok(eng):
        """True when hit expansion can run on host (fl_exact_pre_block
        writes padded key arrays in place of the device's random pos[]
        gathers).  Needs the seq-by-seq
        full-cover interval regime (contiguous intervals spanning the
        whole concatenated reference, one per sequence — the engine's
        SEQBYSEQ mode, nseq < 512): the union of in-range slices is
        then the seed's full position run, and the per-hit sequence
        ids the C pre-block ships let the device scan per interval.
        This regime has no k <= 14 gate (the device never touches the
        k-mer table) and no nseq <= 8 gate (no static V loop)."""
        if not (eng.params.rmapflg & eng_mod.RMAPFLG_SEQBYSEQ):
            return False                # whole-genome cutoff regime
        if eng.refset.nseq > 511:       # 9-bit seqidx field in w5
            return False
        idx = eng.index
        if idx.nskip > idx.wordlen:
            return False
        iv = eng._seq_ivals
        return (int(iv[0, 0]) == 0 and
                int(iv[-1, 1]) >= eng.refset.total_len and
                bool((iv[1:, 0] == iv[:-1, 1]).all()))

    @property
    def _host_hits(self):
        return self._host_hits_ok(self.lane.engine)

    def _collate_fn(self):
        if self._collate is not None:
            return self._collate
        import os
        from ..parallel.exact_collate import CollateCfg, \
            build_exact_collate
        from ..parallel.mesh import DeviceIndex
        eng = self.lane.engine
        idx = eng.index
        host_hits = self._host_hits
        # cache the device residency AND the built jit on the index
        # object: every run builds a fresh engine/DeviceExact, and must
        # not re-ship ~300 MB of residency or re-trace.
        # host_hits only ever reads ref_alpha — skip the table/pos
        # residency entirely (also what lifts the k <= 14 gate there).
        if self._di is None:
            self._di = getattr(idx, "_dx_di", None)
            if self._di is None or (not host_hits and
                                    self._di.table is None and
                                    self._di.hi_table is None):
                self._di = (DeviceIndex.build_ref_only(eng.refset, idx)
                            if host_hits
                            else DeviceIndex.build(eng.refset, idx))
                idx._dx_di = self._di
        p = eng.params
        # per-lane hit cap and pass-1 window pad scale with the read
        # cap: the fixed H=128/SPAD=128 re-staged EVERY >= 128 bp read
        # (window slen ~ qlen + band) and overflowed ~40% of 150 bp
        # lanes; <= 128 bp reads keep the measured-optimal 128s
        qscale = max(1, self._qcap // 128)
        H = (int(os.environ.get("SMALT_DX_H", 128 * qscale))
             if host_hits else 512)
        cfg = CollateCfg(wordlen=idx.wordlen,
                         nskip=idx.nskip,
                         maxhit=p.ktuple_maxhit,
                         B=self.batch, Q=self._qcap, H=H,
                         # SMALT_DX_POOL (x batch): the cumulative
                         # candidate-pool cap is the measured dominant
                         # restage source on 150 bp repeat corpora
                         # (3.3k -> 0.5k flagged mates at 12xB), but
                         # every pool row is a scored pass-1 window;
                         # the default 6 is not yet sized on the card
                         P=int(os.environ.get("SMALT_DX_POOL", 6)) *
                         self.batch,
                         V=1 if host_hits else eng.refset.nseq,
                         host_hits=host_hits,
                         NS=eng.refset.nseq if host_hits else 1,
                         SPAD=(128 if self._qcap <= 128
                               else self._qcap + 128))
        matrix = np.asarray(eng.matrix)
        key = (cfg, matrix.tobytes(), eng.gapopen, eng.gapext)
        steps = getattr(idx, "_dx_steps", None)
        if steps is None:
            steps = idx._dx_steps = {}
        fn = steps.get(key)
        if fn is None:
            fn = build_exact_collate(self._di, eng._seq_ivals, matrix,
                                     -eng.gapopen, -eng.gapext, cfg)
            steps[key] = fn
        self._collate = fn
        self._cfg = cfg
        return self._collate

    # ---------------- host halves ----------------

    def _pre(self, n, codes, read_offs, quals, has_qual, Qcap,
             hits_B=0, hits_H=0):
        """hits_B > 0: also host-expand the packed hit keys into
        B-padded [B, 2, H] arrays (host_hits mode)."""
        lane = self.lane
        p = lane.engine.params
        wa, sa, nwords, ta, pa = lane._idx_addrs
        idx = lane.engine.index
        pre = np.zeros((n, 12), np.int64)
        selmask = np.zeros((n, 2, Qcap), np.uint8)
        nseq = lane.engine.refset.nseq
        ks = None
        if hits_B:
            k1 = np.zeros((hits_B, 2, hits_H), np.int32)
            k2 = np.zeros((hits_B, 2, hits_H), np.uint8)
            tot = np.zeros((hits_B, 2), np.int32)
            if nseq > 1:        # per-hit sequence index (interval id)
                ks = np.zeros((hits_B, 2, hits_H), np.int32)
            args = (pa, hits_H, k1.ctypes.data, k2.ctypes.data,
                    tot.ctypes.data, lane._offsets.ctypes.data, nseq,
                    ks.ctypes.data if ks is not None else None)
        else:
            k1 = k2 = tot = None
            args = (None, 0, None, None, None, None, 0, None)
        rc = lane.lib.fl_exact_pre_block(
            wa, sa, nwords, ta, idx.wordlen, idx.nskip,
            p.ktuple_maxhit, eng_mod.HASH_MAXNHITS, p.min_basq,
            p.min_cover_frac, 1,
            n, codes.ctypes.data, read_offs.ctypes.data,
            quals.ctypes.data, has_qual.ctypes.data,
            Qcap, pre.ctypes.data, selmask.ctypes.data, *args)
        if rc != 0:
            return None
        return pre, selmask, k1, k2, tot, ks

    def _post(self, n, read_offs, pre, pool, counts2, scores, cksum,
              fallback, pair=False):
        """pair=True: replay the depth sort under the PAIR flow's
        parameter mods (fl_pair_map_single: MINSCOR_BELOW_MAX_BEST=0,
        rmapflg|PAIRED&~ALLPAIR) so the state equals what the pair
        flow's unrestricted stage 1 would produce."""
        lane = self.lane
        eng = lane.engine
        p = eng.params
        belowmax = 0 if pair else p.min_swatscor_below_max
        rflg = ((p.rmapflg | eng_mod.RMAPFLG_PAIRED)
                if pair else p.rmapflg) & ~eng_mod.RMAPFLG_ALLPAIR
        state_cap = n * 8 + int(counts2.sum()) * 12 + 64
        pool_c = np.ascontiguousarray(pool, np.int32)
        counts2_c = np.ascontiguousarray(counts2, np.int32)
        scores_c = np.ascontiguousarray(scores, np.int32)
        cksum_c = np.ascontiguousarray(cksum, np.int32)
        fb_c = np.ascontiguousarray(fallback, np.uint8)
        nrest = np.zeros(1, np.int64)
        state = np.empty(state_cap, np.int64)
        state_offs = np.empty(n + 1, np.int64)
        rc = lane.lib.fl_exact_post_block(
            eng.index.wordlen, eng.index.nskip,
            lane._offsets.ctypes.data, eng.refset.nseq,
            belowmax,
            lane._avgs[0], lane._avgs[1],
            p.target_depth, p.max_depth,
            rflg,
            n, read_offs.ctypes.data, pre.ctypes.data,
            pool_c.ctypes.data, counts2_c.ctypes.data,
            scores_c.ctypes.data, len(scores_c),
            fb_c.ctypes.data, cksum_c.ctypes.data,
            state.ctypes.data, state_cap, state_offs.ctypes.data,
            nrest.ctypes.data)
        if rc != 0:
            return None
        return state, state_offs, int(nrest[0])

    # ---------------- device pass 2 ----------------

    def _pass2_step(self):
        if self._p2_fn is not None:
            return self._p2_fn
        from ..parallel.exact_pass2 import build_pass2_step
        eng = self.lane.engine
        matrix = np.asarray(eng.matrix, np.int32)
        self._p2_fn = build_pass2_step(matrix.tobytes(), matrix.shape,
                                       -eng.gapopen, -eng.gapext)
        return self._p2_fn

    def _prep_windows(self, n, codes, read_offs, state, state_offs,
                      scores64):
        """fl_pass2_prep_block: replayed per-candidate scores + the
        pass-2 window descriptors.  Returns (pres, phdr, win[nw,12])
        or None (legacy host pass 2)."""
        lane = self.lane
        eng = lane.engine
        p = eng.params
        idx = eng.index
        n_rows = int((int(state_offs[n]) - 8 * n) // 12)
        pres = np.zeros(max(n_rows, 1), np.int64)
        phdr = np.zeros(max(n * 4, 4), np.int64)
        win_cap = max(n_rows, 64)
        for _ in range(3):
            win = np.empty(win_cap * 12, np.int64)
            rc = lane.lib.fl_pass2_prep_block(
                lane._matrix.ctypes.data, -eng.gapopen, -eng.gapext,
                lane._avgs[0], lane._avgs[1],
                lane._refcodes.ctypes.data, lane._offsets.ctypes.data,
                eng.refset.nseq, idx.wordlen, idx.nskip,
                p.min_swatscor, p.min_swatscor_below_max,
                p.rmapflg & ~eng_mod.RMAPFLG_ALLPAIR, 1,
                n, codes.ctypes.data, read_offs.ctypes.data,
                state.ctypes.data, state_offs.ctypes.data,
                scores64.ctypes.data, len(scores64),
                pres.ctypes.data, phdr.ctypes.data,
                win.ctypes.data, win_cap)
            if rc == -1:              # window capacity: grow and retry
                win_cap *= 4
                continue
            if rc < 0:
                return None
            return pres, phdr, win[: int(rc) * 12].reshape(-1, 12)
        return None

    def _dispatch_pass2(self, win, codes_pad, qlens):
        """One device dispatch over the prep windows; returns
        (best64, mi64, mj64, rec16, valid, sp, nwin) with sticky
        shapes (one compile per run)."""
        import jax
        nw = len(win)
        # track read-cap growth (the __init__ value assumed the 128
        # default; 150 bp reads need wider pass-2 bands)
        self._p2_sp = max(self._p2_sp, 2 * self._qcap)
        Sp = self._p2_sp
        valid = ((win[:, 10] == 1) & (win[:, 2] <= Sp) &
                 (win[:, 9] <= Sp)).astype(np.uint8)
        while self._p2_wcap < nw:
            self._p2_wcap *= 2
        wd = np.zeros((self._p2_wcap, 12), np.int32)
        if nw:
            wd[:nw, 0] = win[:, 1]            # gstart
            wd[:nw, 1] = win[:, 2]            # b_s_len
            wd[:nw, 2] = win[:, 0]            # read idx
            wd[:nw, 3] = win[:, 7]            # is_rev
            wd[:nw, 4] = win[:, 3]            # l_edge
            wd[:nw, 5] = win[:, 4]            # r_edge
            wd[:nw, 6] = win[:, 5]            # q_left
            wd[:nw, 7] = win[:, 6]            # q_len
            wd[:nw, 8] = win[:, 8]            # b_s_left
            wd[:nw, 9] = np.where(valid[:nw] != 0, win[:, 9], 0)
        if self._ref_alpha is None:
            self._ref_alpha = jax.device_put(
                (self.lane._refcodes & 7).astype(np.uint8))
        # ONE fused output buffer -> one fetch, and codes_pad arrives
        # as the batch's already-resident device buffer (no re-upload)
        from ..parallel.exact_pass2 import unpack_pass2
        flat = self._pass2_step()(
            self._ref_alpha, codes_pad, qlens, wd, Sp)
        best64, mi64, mj64, rec16 = unpack_pass2(
            np.asarray(flat), nw, Sp)
        if os.environ.get("SMALT_DX_DEBUG"):
            import sys as _s
            v = valid[:nw] != 0
            print(f"# p2-dispatch nw={nw} valid={int(v.sum())} "
                  f"best>0={int((best64[v] > 0).sum())} "
                  f"best_mean={float(best64[v].mean()) if v.any() else 0:.1f}",
                  file=_s.stderr, flush=True)
        return best64, mi64, mj64, rec16, valid, Sp, nw

    # ---------------- driver ----------------

    def run_raw_fastq(self, path: str, out, fallback,
                      resume_log=None) -> None:
        """Map a FASTQ file: host pre (hit info + rank masks) -> ONE
        device dispatch (collation + pass-1 scores) on a worker thread
        -> host post (depth sort + state) -> device pass-2 dispatch
        (banded track fill + walk, exact_pass2.py) -> fl_pass2_block
        consuming the walk records.  Blocks the device cannot serve
        fall back per read (host re-stage) or per candidate (decode
        doubt -> host DP) or, on hard errors, per batch (no RNG
        consumed until pass 2).

        resume_log: ResumeLog sidecar — checkpoints {reads written,
        output bytes, drand48 state} after each in-order batch write
        (no RNG is consumed before pass 2, so batch skipping on resume
        replays the identical stream, like the host loop in
        pipeline.py)."""
        import os
        import sys
        import time
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor
        from .fastmode import iter_fastq_batches

        timing = bool(os.environ.get("SMALT_DP1_TIMING"))
        minq = self.lane.engine.params.min_basq + 0x21
        pending = deque()
        pool_exec = ThreadPoolExecutor(max_workers=1)
        self.n_restaged = 0

        def device_leg(*args):
            t0 = time.time()
            res = self._collate_fn()(*args)
            outs = [np.asarray(x) for x in res]
            if timing:
                print(f"# dx-dev {time.time() - t0:.3f}s",
                      file=sys.stderr, flush=True)
            return outs

        def prepare(names, seqs, quals):
            t0 = time.time() if timing else 0
            n = len(names)
            read_offs = np.zeros(n + 1, dtype=np.int64)
            np.cumsum([len(s) for s in seqs], out=read_offs[1:])
            name_offs = np.zeros(n + 1, dtype=np.int64)
            np.cumsum([len(x) for x in names], out=name_offs[1:])
            qlens_n = (read_offs[1:] - read_offs[:-1]).astype(np.int32)
            qmax = int(qlens_n.max()) if n else 1
            if qmax > self.QMAX or n > self.batch:
                return None
            while self._qcap < qmax:
                self._qcap *= 2
                self._collate = None        # new shape: rebuild the jit
            Qcap = self._qcap
            has_qual = np.empty(n, dtype=np.uint8)
            qp = []
            for i, q in enumerate(quals):
                if q is not None and len(q) == len(seqs[i]):
                    has_qual[i] = 1
                    qp.append(q)
                else:
                    return None
            codes = np.frombuffer(b"".join(seqs) or b"\0", np.uint8)
            qarr = np.frombuffer(b"".join(qp) or b"\0", np.uint8)
            narr = np.frombuffer(b"".join(names) or b"\0", np.uint8)
            B = self.batch
            host_hits = self._host_hits
            if host_hits:
                # the collate cfg's H (build it first so cfg exists)
                self._collate_fn()
                st = self._pre(n, codes, read_offs, qarr, has_qual,
                               Qcap, hits_B=B, hits_H=self._cfg.H)
            else:
                st = self._pre(n, codes, read_offs, qarr, has_qual,
                               Qcap)
            if st is None:
                return None
            pre, selmask, k1, k2, tot, ks = st
            # fixed-shape device inputs (pad reads to the block size)
            codes_pad = np.zeros((B, Qcap), np.uint8)
            enc = np.frombuffer(codec_encode_bulk(codes), np.uint8)
            for i in range(n):
                o, e = int(read_offs[i]), int(read_offs[i + 1])
                codes_pad[i, : e - o] = enc[o:e]
            qlens = np.zeros(B, np.int32)
            qlens[:n] = qlens_n
            if self._p2_on:
                # ship the padded batch ONCE: both the collate and the
                # pass-2 dispatch read it
                import jax as _jax
                codes_pad = _jax.device_put(codes_pad)
            mincov = np.zeros(B, np.int32)
            mincov[:n] = pre[:, 5].astype(np.int32)
            if host_hits:
                # lanes the expansion could not fit re-stage on host
                host_fb = (tot[:n] < 0).any(axis=1)
                np.maximum(tot, 0, out=tot)
                R = 2 * B
                hargs = (k1.reshape(R, self._cfg.H),
                         k2.reshape(R, self._cfg.H), tot.reshape(R),
                         codes_pad, qlens, mincov)
                if ks is not None:
                    hargs = (ks.reshape(R, self._cfg.H),) + hargs
                fut = pool_exec.submit(device_leg, *hargs)
            else:
                host_fb = None
                qbad = np.zeros((B, Qcap), bool)
                for i in range(n):
                    if has_qual[i]:
                        o, e = int(read_offs[i]), int(read_offs[i + 1])
                        qbad[i, : e - o] = qarr[o:e] < minq
                selm_pad = np.zeros((B, 2, Qcap), np.uint8)
                selm_pad[:n] = selmask
                fut = pool_exec.submit(device_leg, codes_pad, qbad,
                                       selm_pad, qlens, mincov)
            if timing:
                print(f"# dx-prep {time.time() - t0:.3f}s",
                      file=sys.stderr, flush=True)
            return (n, qmax, codes, read_offs, qarr, has_qual, narr,
                    name_offs, pre, host_fb, fut, codes_pad, qlens)

        def mid(item, raw):
            """Front-half results -> host post -> window prep ->
            device pass-2 dispatch.  Returns a fin() item, or SAM text
            (fallback) when any stage errors."""
            (n, qmax, codes, read_offs, qarr, has_qual, narr, name_offs,
             pre, host_fb, fut, codes_pad, qlens) = item
            try:
                outs = fut.result()
            except Exception:
                if os.environ.get("SMALT_DX_DEBUG"):
                    import traceback; traceback.print_exc()
                return fallback(*raw)
            if len(outs) == 5:
                pool, counts2, scores, cksum, fb = outs
            else:          # host_hits step has no device checksum
                pool, counts2, scores, fb = outs
                cksum = np.ascontiguousarray(
                    pre[:, 6:10].reshape(n, 2, 2), np.int32)
            fb = fb.copy()
            if host_fb is not None:
                fb[:n] |= host_fb
            t0 = time.time() if timing else 0
            st = self._post(n, read_offs, pre, pool, counts2[:n],
                            scores, cksum[:n], fb[:n])
            if st is None:
                return fallback(*raw)
            state, state_offs, nrest = st
            self.n_restaged += nrest
            scores64 = np.ascontiguousarray(scores, np.int64)
            fut2 = prep = None
            if self._p2_on:
                prep = self._prep_windows(n, codes, read_offs, state,
                                          state_offs, scores64)
                if prep is not None and len(prep[2]):
                    fut2 = pool_exec.submit(self._dispatch_pass2,
                                            prep[2], codes_pad, qlens)
            if timing:
                print(f"# dx-post {time.time() - t0:.3f}s "
                      f"restaged={nrest}", file=sys.stderr, flush=True)
            return (n, qmax, codes, read_offs, qarr, has_qual, narr,
                    name_offs, state, state_offs, scores64, prep, fut2)

        def fin(item, raw):
            if isinstance(item, str):          # mid() fell back
                return item
            (n, qmax, codes, read_offs, qarr, has_qual, narr, name_offs,
             state, state_offs, scores64, prep, fut2) = item
            dev = None
            if fut2 is not None:
                try:
                    best64, mi64, mj64, rec16, valid, sp, nw = \
                        fut2.result()
                    dev = (prep[0], prep[1], best64, mi64, mj64,
                           rec16, valid, sp, nw)
                except Exception:
                    if os.environ.get("SMALT_DX_DEBUG"):
                        import traceback; traceback.print_exc()
                    dev = None
            t1 = time.time() if timing else 0
            text = self._pass2(n, qmax, codes, read_offs, qarr,
                               has_qual, narr, name_offs, state,
                               state_offs, scores64,
                               ascii_codes=True, names_raw=True,
                               dev=dev)
            if dev is not None:
                self.p2_used += int(self._dev_stats[0])
                self.p2_fb += int(self._dev_stats[1])
                self.p2_hit += int(self._dev_stats[2])
            if timing:
                print(f"# dx-pass2 {time.time() - t1:.3f}s n={n} "
                      f"p2_used={self.p2_used} p2_fb={self.p2_fb} "
                      f"p2_hit={self.p2_hit}",
                      file=sys.stderr, flush=True)
            if text is None:
                text = fallback(*raw)
            return text

        skip = 0
        if resume_log is not None:
            st = resume_log.load()
            if st:
                skip = st["reads_done"]
                rand._global._x = st["rng"]
        reads_seen = 0
        written = [0]

        def write_out(text, nreads):
            out.write(text)
            written[0] += nreads
            if resume_log is not None:
                out.flush()
                resume_log.tick(written[0], out.tell(),
                                rand._global._x)

        midq = deque()
        finq = deque()
        try:
            for raw in iter_fastq_batches(path, self.batch):
                reads_seen += len(raw[0])
                if reads_seen <= skip:
                    written[0] = reads_seen   # checkpointed: skip
                    continue
                item = prepare(*raw)
                if item is None:
                    write_out(fallback(*raw), len(raw[0]))
                    continue
                midq.append((item, raw))
                while len(midq) > 1:
                    it, rw = midq.popleft()
                    finq.append((mid(it, rw), rw))
                while len(finq) > 1:
                    it, rw = finq.popleft()
                    write_out(fin(it, rw), len(rw[0]))
            while midq:
                it, rw = midq.popleft()
                finq.append((mid(it, rw), rw))
            while finq:
                it, rw = finq.popleft()
                write_out(fin(it, rw), len(rw[0]))
        finally:
            pool_exec.shutdown(wait=True)
        if resume_log is not None:
            resume_log.done()

    # ---------------- paired-end driver ----------------

    def run_raw_pairs(self, plane, pathA: str, pathB: str, out,
                      oracle_one_pair, mk_pair) -> None:
        """Device-exact paired-end mapping (VERDICT r4 #2): both
        mates' front halves (hit collection, collation, pass-1
        scoring) run through the device collate block — A mates at
        rows 0..n-1, B mates at n..2n-1 of one dispatch — and the C
        pair lane (fl_map_pair_block) consumes the resulting state
        for its UNRESTRICTED mapping calls (fl_pair_map_single_dev);
        mate rescue, interval-restricted remaps and the fine re-hash
        stay on host (the rare data-dependent path, rmap.c:1965-2060).
        Byte-identity is unconditional: flagged mates (capacity /
        checksum / geometry) put their whole pair back on the host
        flow, and uncovered pairs replay through the Python oracle on
        the same drand48 stream exactly as the host pair lane does.

        plane: PairLane; oracle_one_pair(pair) -> SAM text;
        mk_pair(i, batch arrays...) -> (Read, Read)."""
        import sys
        import time
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor
        from .fastmode import iter_fastq_batches

        timing = bool(os.environ.get("SMALT_DP1_TIMING"))
        npairs = self.batch // 2
        pool_exec = ThreadPoolExecutor(max_workers=1)
        self.n_restaged = 0

        def device_leg(*args):
            t0 = time.time()
            res = self._collate_fn()(*args)
            outs = [np.asarray(x) for x in res]
            if timing:
                print(f"# dxp-dev {time.time() - t0:.3f}s",
                      file=sys.stderr, flush=True)
            return outs

        def prepare(nmA, sqA, qlA_, nmB, sqB, qlB_):
            t0 = time.time() if timing else 0
            npr = len(nmA)
            n = 2 * npr
            seqs = list(sqA) + list(sqB)
            quals = list(qlA_) + list(qlB_)
            read_offs = np.zeros(n + 1, dtype=np.int64)
            np.cumsum([len(s) for s in seqs], out=read_offs[1:])
            qlens_n = (read_offs[1:] - read_offs[:-1]).astype(np.int32)
            qmax = int(qlens_n.max()) if n else 1
            if qmax > self.QMAX or npr > npairs:
                return None
            while self._qcap < qmax:
                self._qcap *= 2
                self._collate = None
            Qcap = self._qcap
            has_qual = np.empty(n, dtype=np.uint8)
            qp = []
            for i, q in enumerate(quals):
                if q is not None and len(q) == len(seqs[i]):
                    has_qual[i] = 1
                    qp.append(q)
                else:
                    return None
            codes = np.frombuffer(b"".join(seqs) or b"\0", np.uint8)
            qarr = np.frombuffer(b"".join(qp) or b"\0", np.uint8)
            B = self.batch
            host_hits = self._host_hits
            if host_hits:
                self._collate_fn()
                st = self._pre(n, codes, read_offs, qarr, has_qual,
                               Qcap, hits_B=B, hits_H=self._cfg.H)
            else:
                st = self._pre(n, codes, read_offs, qarr, has_qual,
                               Qcap)
            if st is None:
                return None
            pre, selmask, k1, k2, tot, ks = st
            codes_pad = np.zeros((B, Qcap), np.uint8)
            enc = np.frombuffer(codec_encode_bulk(codes), np.uint8)
            for i in range(n):
                o, e = int(read_offs[i]), int(read_offs[i + 1])
                codes_pad[i, : e - o] = enc[o:e]
            qlens = np.zeros(B, np.int32)
            qlens[:n] = qlens_n
            mincov = np.zeros(B, np.int32)
            mincov[:n] = pre[:, 5].astype(np.int32)
            if host_hits:
                host_fb = (tot[:n] < 0).any(axis=1)
                np.maximum(tot, 0, out=tot)
                R = 2 * B
                hargs = (k1.reshape(R, self._cfg.H),
                         k2.reshape(R, self._cfg.H), tot.reshape(R),
                         codes_pad, qlens, mincov)
                if ks is not None:
                    hargs = (ks.reshape(R, self._cfg.H),) + hargs
                fut = pool_exec.submit(device_leg, *hargs)
            else:
                host_fb = None
                minq = self.lane.engine.params.min_basq + 0x21
                qbad = np.zeros((B, Qcap), bool)
                for i in range(n):
                    if has_qual[i]:
                        o, e = int(read_offs[i]), int(read_offs[i + 1])
                        qbad[i, : e - o] = qarr[o:e] < minq
                selm_pad = np.zeros((B, 2, Qcap), np.uint8)
                selm_pad[:n] = selmask
                fut = pool_exec.submit(device_leg, codes_pad, qbad,
                                       selm_pad, qlens, mincov)
            if timing:
                print(f"# dxp-prep {time.time() - t0:.3f}s",
                      file=sys.stderr, flush=True)
            return (n, read_offs, pre, host_fb, fut)

        def mid(item):
            n, read_offs, pre, host_fb, fut = item
            try:
                outs = fut.result()
            except Exception:
                if os.environ.get("SMALT_DX_DEBUG"):
                    import traceback
                    traceback.print_exc()
                return None
            if len(outs) == 5:
                pool, counts2, scores, cksum, fb = outs
            else:
                pool, counts2, scores, fb = outs
                cksum = np.ascontiguousarray(
                    pre[:, 6:10].reshape(n, 2, 2), np.int32)
            fb = fb.copy()
            if host_fb is not None:
                fb[:n] |= host_fb
            t0 = time.time() if timing else 0
            st = self._post(n, read_offs, pre, pool, counts2[:n],
                            scores, cksum[:n], fb[:n], pair=True)
            if st is None:
                return None
            state, state_offs, nrest = st
            self.n_restaged += nrest
            scores64 = np.ascontiguousarray(scores, np.int64)
            if timing:
                print(f"# dxp-post {time.time() - t0:.3f}s "
                      f"restaged={nrest}", file=sys.stderr, flush=True)
            return state, state_offs, scores64

        def fin(item, raw):
            nmA, sqA, qlA_, nmB, sqB, qlB_ = raw

            def oracle_one(i):
                return oracle_one_pair(mk_pair(i, *raw))

            if item is None:
                return None
            state, state_offs, scores64 = item
            npr = len(nmA)
            doffA = np.ascontiguousarray(state_offs[:npr])
            doffB = np.ascontiguousarray(state_offs[npr:2 * npr])
            parts = []
            start = 0
            t0 = time.time() if timing else 0
            while start < npr:
                arrA = plane._raw_arrays(nmA[start:], sqA[start:],
                                         qlA_[start:])
                arrB = plane._raw_arrays(nmB[start:], sqB[start:],
                                         qlB_[start:])
                if arrA is None or arrB is None:
                    return None
                dev = (state, np.ascontiguousarray(doffA[start:]),
                       np.ascontiguousarray(doffB[start:]), scores64)
                res = plane._call_arrays(npr - start, arrA, arrB,
                                         ascii_codes=True,
                                         names_raw=True, dev=dev)
                if res is None:
                    if start == 0:
                        return None
                    for i in range(start, npr):
                        parts.append(oracle_one(i))
                    start = npr
                    break
                text, ndone = res
                parts.append(text)
                start += ndone
                if start < npr:
                    parts.append(oracle_one(start))
                    start += 1
            if timing:
                print(f"# dxp-tail {time.time() - t0:.3f}s "
                      f"npairs={npr}", file=sys.stderr, flush=True)
            return "".join(parts)

        def host_batch(raw):
            """Whole-batch host fallback: the plain pair lane with
            the per-pair oracle protocol (byte-identical)."""
            nmA, sqA, qlA_, nmB, sqB, qlB_ = raw

            def oracle_one(i):
                return oracle_one_pair(mk_pair(i, *raw))

            text = plane.render_raw_pairs(nmA, sqA, qlA_, nmB, sqB,
                                          qlB_, oracle_one)
            if text is None:
                parts = [oracle_one(i) for i in range(len(nmA))]
                text = "".join(parts)
            return text

        midq = deque()
        itB = iter_fastq_batches(pathB, npairs)
        try:
            for nmA, sqA, qlA_ in iter_fastq_batches(pathA, npairs):
                nmB, sqB, qlB_ = next(itB, (None, None, None))
                if nmB is None or len(nmB) != len(nmA):
                    raise ValueError(
                        "paired files have different read counts")
                raw = (nmA, sqA, qlA_, nmB, sqB, qlB_)
                item = prepare(*raw)
                if item is None:
                    out.write(host_batch(raw))
                    continue
                midq.append((item, raw))
                while len(midq) > 1:
                    it, rw = midq.popleft()
                    text = fin(mid(it), rw)
                    out.write(text if text is not None
                              else host_batch(rw))
            while midq:
                it, rw = midq.popleft()
                text = fin(mid(it), rw)
                out.write(text if text is not None else host_batch(rw))
            if next(itB, None) is not None:
                raise ValueError(
                    "paired files have different read counts")
        finally:
            pool_exec.shutdown(wait=True)


def codec_encode_bulk(ascii_codes: np.ndarray) -> bytes:
    """ASCII read letters -> mangled codes (vectorized CODTAB gather)."""
    from ..seq import codec
    return codec.CODTAB[ascii_codes].tobytes()


import functools


@functools.lru_cache(maxsize=8)
def _dp1_step_fn(matrix_bytes: bytes, matrix_shape, go: int, ge: int):
    """Module-level cached jit of the DevicePass1 device stage (shared
    trace + executable across instances; the persistent XLA cache of
    device.py reuses it across processes too)."""
    import jax
    import jax.numpy as jnp
    from ..device import ensure_compile_cache
    from ..ops.sw import sw_scores

    ensure_compile_cache()
    matrix = np.frombuffer(matrix_bytes, np.int32).reshape(matrix_shape)

    @functools.partial(jax.jit, static_argnames=("S",))
    def step(ref_alpha, reads, qlens, wd, S):
        # wd: [W, 4] int32 {start, slen, read_idx, is_rev} — ONE
        # combined descriptor array: one H2D transfer instead of four
        starts, slens, ridx, is_rev = (wd[:, 0], wd[:, 1], wd[:, 2],
                                       wd[:, 3])
        reads = reads.astype(jnp.int32)           # [n, Q] alpha codes
        n, Q = reads.shape
        # reverse complement with per-read length (padding code 7)
        j = jnp.arange(Q, dtype=jnp.int32)[None, :]
        src = qlens[:, None] - 1 - j
        valid = src >= 0
        g = jnp.take_along_axis(reads, jnp.maximum(src, 0), axis=1)
        std = (g & 4) == 0
        rcq = jnp.where(valid, jnp.where(std, g ^ 3, g), 7)
        qcs = jnp.where((is_rev == 1)[:, None], rcq[ridx], reads[ridx])
        # on-device window gather from the resident reference
        offs = jnp.arange(S, dtype=jnp.int32)[None, :]
        gidx = jnp.clip(starts[:, None] + offs, 0,
                        ref_alpha.shape[0] - 1)
        wins = jnp.where(offs >= slens[:, None], 7,
                         ref_alpha[gidx].astype(jnp.int32))
        return sw_scores(qcs, wins, slens, matrix, go, ge)

    return step
