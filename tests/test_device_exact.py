"""Differential tests: device-exact collation (parallel/exact_collate)
vs the host C oracle (native/mapcore.c mc_collect_all + mc_score_cands).

The device pipeline re-derives hit info from the resident index, expands
and sorts the packed hits, forms seeds/segments/regions/candidates in
one scan, and scores SIMD-eligible windows — all of which must equal the
C lane's view bit for bit for `--device-exact` to stay byte-identical.
Runs on the CPU backend (conftest forces it)."""
import os

import numpy as np
import pytest

from smalt_tpu.seq.refset import RefSet
from smalt_tpu.seq import codec
from smalt_tpu.seq.codec import revcomp_codes
from smalt_tpu.seq.io import Read
from smalt_tpu.index.table import build_index
from smalt_tpu.map.engine import MapEngine, MapParams
from smalt_tpu.align.core import ScoreProfile
from smalt_tpu.parallel.mesh import DeviceIndex
from smalt_tpu.parallel.exact_collate import CollateCfg, build_exact_collate
from smalt_tpu.native import get_lib

QLEN = 100


def _corpus(tmp_path, seed, k, nskip, nreads, glen=36000):
    rng = np.random.default_rng(seed)
    bases = "ACGT"
    seqs = []
    fa = tmp_path / "g.fa"
    with open(fa, "w") as f:
        for s in range(3):
            L = glen // 3
            g = "".join(rng.choice(list(bases), L))
            unit = "".join(rng.choice(list(bases), 300))
            for _ in range(5):       # planted repeats: multi-cand paths
                at = int(rng.integers(0, L - 300))
                g = g[:at] + unit + g[at + 300:]
            seqs.append(g)
            f.write(f">s{s}\n{g}\n")
    refset = RefSet.from_fasta(str(fa))
    idx = build_index(refset, k, nskip)
    _ = idx.addrs
    reads = []
    for _ in range(nreads):
        s = int(rng.integers(0, 3))
        pos = int(rng.integers(0, len(seqs[s]) - QLEN))
        r = list(seqs[s][pos:pos + QLEN])
        for j in np.flatnonzero(rng.random(QLEN) < 0.02):
            r[j] = bases[int(rng.integers(0, 4))]
        if rng.random() < 0.25:      # Ns exercise the bad-base windows
            r[int(rng.integers(0, QLEN))] = "N"
        r = "".join(r)
        if rng.random() < 0.5:
            r = r.translate(str.maketrans("ACGT", "TGCA"))[::-1]
        q = rng.integers(35, 74, QLEN).astype(np.uint8)
        reads.append((r, q.tobytes()))
    return refset, idx, reads


def _host_oracle(eng, idx, lib, reads):
    """Per read: mc_collect_all rows + the rank-selected seed mask."""
    rows, sels, mincovs = [], [], []
    for rseq, rq in reads:
        rd = Read("x", codec.encode(rseq.encode()), rq)
        hf, hr = eng._hitinfo(rd, idx, True)
        min_cover = eng._covermin(rd)
        ktup, nskip = idx.wordlen, idx.nskip
        if min_cover >= ktup + nskip:
            min_ktup = (min_cover - ktup) // nskip
        else:
            min_ktup = 1
        min_cover = (min_ktup - 1) * nskip + ktup
        sac = eng._collect_native(lib, hf, hr, idx, min_ktup, min_cover,
                                  None)
        rows.append(np.asarray(sac.rows_arr))
        sel = np.zeros((2, QLEN), np.uint8)
        for s_i, hi_ in ((0, hf), (1, hr)):
            nsel = hi_.seed_rank if hi_.seed_rank > 0 else hi_.n_seeds
            sel[s_i, hi_.qoffs[hi_.sidx[:nsel]]] = 1
        sels.append(sel)
        mincovs.append(min_cover)
    return rows, sels, mincovs


def _device_run(eng, refset, idx, reads, sels, mincovs, H=512, C=16):
    B = len(reads)
    cfg = CollateCfg(wordlen=idx.wordlen, nskip=idx.nskip, maxhit=10000,
                     B=B, Q=128, H=H, C=C, V=refset.nseq)
    di = DeviceIndex.build(refset, idx)
    step = build_exact_collate(di, eng._seq_ivals, np.asarray(eng.matrix),
                               -eng.gapopen, -eng.gapext, cfg)
    codes = np.zeros((B, 128), np.uint8)
    qbad = np.zeros((B, 128), bool)
    qlens = np.full(B, QLEN, np.int32)
    selm = np.zeros((B, 2, 128), np.uint8)
    minq = eng.params.min_basq + 0x21
    for i, (rseq, rq) in enumerate(reads):
        codes[i, :QLEN] = codec.encode(rseq.encode())
        qbad[i, :QLEN] = np.frombuffer(rq, np.uint8) < minq
        selm[i, :, :QLEN] = sels[i]
    mc = np.asarray(mincovs, np.int32)
    return [np.asarray(x) for x in step(codes, qbad, selm, qlens, mc)]


def _unpack(row):
    w0, rs, re, dsh, s2mm, w5 = (int(x) for x in row)
    return (w0 & 0xFF, (w0 >> 8) & 0xFF, rs, re, dsh, s2mm,
            w5 & 0x3FFFFF, (w0 >> 16) & 0xFF, ((w5 >> 31) & 1) * 2,
            (w0 >> 24) & 0xFF, (w5 >> 22) & 0x1FF)


@pytest.mark.parametrize("seed,k,nskip", [(1, 11, 2), (2, 13, 4),
                                          (3, 12, 1)])
def test_rows_and_scores_match_host(tmp_path, seed, k, nskip):
    lib = get_lib()
    if lib is None:
        pytest.skip("native lib required")
    refset, idx, reads = _corpus(tmp_path, seed, k, nskip, nreads=32)
    eng = MapEngine(refset, idx, MapParams())
    host_rows, sels, mincovs = _host_oracle(eng, idx, lib, reads)
    pool, counts2, scores, cksum, fallback = _device_run(
        eng, refset, idx, reads, sels, mincovs)
    offs = np.concatenate([[0], np.cumsum(counts2.sum(axis=1))])
    n_compared = 0
    for i, hr_ in enumerate(host_rows):
        if fallback[i]:
            continue
        got = pool[offs[i]:offs[i + 1]]
        assert len(got) == len(hr_), f"read {i} candidate count"
        for r in range(len(got)):
            qs, qe, rs, re, dsh, s2, srg, cov, mmali, nseg, sq = \
                _unpack(got[r])
            h = [int(x) for x in hr_[r]]
            dev = (qs, qe, rs, re, dsh, s2, srg, cov,
                   (h[8] & 1) | mmali, nseg, sq)
            assert dev == tuple(h), f"read {i} row {r}: {dev} != {h}"
            n_compared += 1
    # the planted-repeat corpus must exercise real multi-cand reads
    assert n_compared > len(reads)
    assert fallback.sum() <= len(reads) // 4

    # pass-1 scores: device kernel vs host mc_score_cands (best=0
    # scores every row in row order; the SIMD gate must agree and the
    # full-matrix scores must be equal)
    n_scored = 0
    for i, hr_ in enumerate(host_rows):
        if fallback[i] or not len(hr_):
            continue
        rseq, rq = reads[i]
        qc = codec.encode(rseq.encode())
        pf = ScoreProfile.from_read(qc, eng.matrix, eng.gapopen,
                                    eng.gapext, eng.lam)
        pr = ScoreProfile.from_read(revcomp_codes(qc), eng.matrix,
                                    eng.gapopen, eng.gapext, eng.lam)
        n = len(hr_)
        out = np.zeros(n * 10, np.int64)
        Hb = np.zeros(QLEN + 8, np.int32)
        Eb = np.zeros(QLEN + 8, np.int32)
        mx = np.zeros(3, np.int64)
        sidx = np.arange(n, dtype=np.uint32)
        rows64 = np.ascontiguousarray(hr_, np.int64)
        rc = lib.mc_score_cands(
            rows64.ctypes.data, sidx.ctypes.data, n, idx.wordlen,
            idx.nskip, refset.codes.ctypes.data,
            refset.offsets.ctypes.data, refset.nseq, QLEN,
            pf.W_addr, pr.W_addr, pf.gap_init_pos, pf.gap_ext_pos,
            pf.match_avg, pf.mismatch_avg, 0, 0, 0,
            Hb.ctypes.data, Eb.ctypes.data, out.ctypes.data,
            mx.ctypes.data)
        assert rc == 0
        out = out.reshape(n, 10)
        for r in range(n):
            host_simd = (QLEN >= 32 and
                         (int(out[r][5]) - int(out[r][4])) * 48 > QLEN and
                         int(out[r][0]) == 0 and int(out[r][1]) >= QLEN - 1)
            dsc = int(scores[offs[i] + r])
            assert host_simd == (dsc >= 0), f"read {i} row {r} simd gate"
            if host_simd:
                assert dsc == int(out[r][8]), f"read {i} row {r} score"
                n_scored += 1
    assert n_scored > 0


def test_end_to_end_byte_identical(tmp_path, monkeypatch):
    """DeviceExact.run_raw_fastq output == the pure host C lane, byte
    for byte, including reads the device re-stages (a heavy-repeat
    read overflows the device hit cap on purpose)."""
    import io
    monkeypatch.setenv("SMALT_DX_P2", "1")   # device pass-2 opt-in
    lib = get_lib()
    if lib is None:
        pytest.skip("native lib required")
    from smalt_tpu import rand
    from smalt_tpu.map.pipeline import run_pipeline_raw_fastq
    from smalt_tpu.map.fastlane import DeviceExact

    rng = np.random.default_rng(11)
    bases = "ACGT"
    unit = "".join(rng.choice(list(bases), 400))
    fa = tmp_path / "g.fa"
    seqs = []
    with open(fa, "w") as f:
        for s in range(2):
            L = 15000
            g = "".join(rng.choice(list(bases), L))
            for _ in range(25):          # heavy repeat: hit-cap overflow
                at = int(rng.integers(0, L - 400))
                g = g[:at] + unit + g[at + 400:]
            seqs.append(g)
            f.write(f">s{s}\n{g}\n")
    refset = RefSet.from_fasta(str(fa))
    idx = build_index(refset, 11, 2)
    _ = idx.addrs
    fq = tmp_path / "r.fq"
    with open(fq, "w") as f:
        for i in range(200):
            s = int(rng.integers(0, 2))
            pos = int(rng.integers(0, len(seqs[s]) - QLEN))
            r = seqs[s][pos:pos + QLEN]
            if i % 2:
                # mutations so the gapless perfect-match shortcut does
                # NOT fire and pass 2 must run the real decode path
                r = list(r)
                for _ in range(3):
                    at = int(rng.integers(0, QLEN))
                    r[at] = "ACGT"[int(rng.integers(0, 4))]
                r = "".join(r)
            if rng.random() < 0.5:
                r = r.translate(str.maketrans("ACGT", "TGCA"))[::-1]
            f.write(f"@r{i}\n{r}\n+\n{'5' * QLEN}\n")
        # reads from the repeat unit itself: guaranteed device restage
        for i in range(4):
            f.write(f"@rep{i}\n{unit[:QLEN]}\n+\n{'5' * QLEN}\n")

    rand.ranseed(1)
    eng = MapEngine(refset, idx, MapParams())
    host = io.StringIO()
    assert run_pipeline_raw_fastq(eng, str(fq), host, refset)

    rand.ranseed(1)
    eng2 = MapEngine(refset, idx, MapParams())
    from smalt_tpu.map.fastlane import FastLane
    lane = FastLane.make(eng2, "sam", True, False, False, False)
    dev = DeviceExact.make(eng2, "sam", True, False, False, False,
                           batch=64)
    assert dev is not None
    sink = io.StringIO()

    def fb(names, seqs_, quals):
        return lane.render_raw_block(names, seqs_, quals)

    dev.run_raw_fastq(str(fq), sink, fb)
    assert sink.getvalue() == host.getvalue()
    assert dev.n_restaged > 0      # the repeat reads exercised restage
    # the device pass-2 decode must actually carry alignments (a wrong
    # device best of 0 silently drops candidates as "used": p2_hit
    # counts decodes that emitted results — the regression guard for
    # the alpha-code masking bug)
    assert dev.p2_used >= 10, (dev.p2_used, dev.p2_fb, dev.p2_hit)
    assert dev.p2_hit >= 5, (dev.p2_used, dev.p2_fb, dev.p2_hit)


def test_end_to_end_host_hits_byte_identical(tmp_path):
    """The host-hits regime (single whole-range interval: the host C
    expands the packed hit keys, the device sorts/collates/scores)
    must also be byte-identical, including hit-cap restages."""
    import io
    lib = get_lib()
    if lib is None:
        pytest.skip("native lib required")
    from smalt_tpu import rand
    from smalt_tpu.map.pipeline import run_pipeline_raw_fastq
    from smalt_tpu.map.fastlane import DeviceExact, FastLane

    rng = np.random.default_rng(23)
    bases = "ACGT"
    unit = "".join(rng.choice(list(bases), 400))
    L = 30000
    g = "".join(rng.choice(list(bases), L))
    for _ in range(20):
        at = int(rng.integers(0, L - 400))
        g = g[:at] + unit + g[at + 400:]
    fa = tmp_path / "g.fa"
    with open(fa, "w") as f:
        f.write(f">s0\n{g}\n")
    refset = RefSet.from_fasta(str(fa))
    assert refset.nseq == 1
    idx = build_index(refset, 11, 2)
    _ = idx.addrs
    fq = tmp_path / "r.fq"
    with open(fq, "w") as f:
        for i in range(200):
            pos = int(rng.integers(0, L - QLEN))
            r = g[pos:pos + QLEN]
            if rng.random() < 0.5:
                r = r.translate(str.maketrans("ACGT", "TGCA"))[::-1]
            f.write(f"@r{i}\n{r}\n+\n{'5' * QLEN}\n")
        for i in range(4):          # repeat reads: hit-cap restage
            f.write(f"@rep{i}\n{unit[:QLEN]}\n+\n{'5' * QLEN}\n")

    rand.ranseed(1)
    eng = MapEngine(refset, idx, MapParams())
    host = io.StringIO()
    assert run_pipeline_raw_fastq(eng, str(fq), host, refset)

    rand.ranseed(1)
    eng2 = MapEngine(refset, idx, MapParams())
    lane = FastLane.make(eng2, "sam", True, False, False, False)
    dev = DeviceExact.make(eng2, "sam", True, False, False, False,
                           batch=64)
    assert dev is not None and dev._host_hits
    sink = io.StringIO()
    dev.run_raw_fastq(str(fq), sink,
                      lambda a, b, c: lane.render_raw_block(a, b, c))
    assert sink.getvalue() == host.getvalue()
    assert dev.n_restaged > 0


@pytest.mark.parametrize("nctg,k,nskip,seed", [(12, 16, 2, 31),
                                               (60, 13, 2, 32)])
def test_end_to_end_multiseq_bigk_byte_identical(tmp_path, monkeypatch,
                                                 nctg, k, nskip, seed):
    """The round-5 gate lifts: --device-exact on a draft-assembly-like
    multi-contig reference (beyond the old nseq <= 8 static-V gate)
    and at k = 16 (beyond the old direct-table k <= 14 gate) — the
    host-hits regime ships per-hit sequence ids and the combined scan
    breaks at interval boundaries (fl_exact_pre_block ks_out;
    exact_collate._segcand_scan ivl).  Byte-identical to the host
    lane, reference semantics rmap.c SEQBYSEQ + menu.c:595 (k <= 20)."""
    import io
    monkeypatch.setenv("SMALT_DX_P2", "1")   # device pass-2 opt-in
    lib = get_lib()
    if lib is None:
        pytest.skip("native lib required")
    from smalt_tpu import rand
    from smalt_tpu.map.pipeline import run_pipeline_raw_fastq
    from smalt_tpu.map.fastlane import DeviceExact, FastLane

    rng = np.random.default_rng(seed)
    bases = "ACGT"
    unit = "".join(rng.choice(list(bases), 300))
    seqs = []
    fa = tmp_path / "g.fa"
    with open(fa, "w") as f:
        for s in range(nctg):
            # uneven contig sizes: boundary serials land mid-word
            L = 1200 + 507 * (s % 5)
            g = "".join(rng.choice(list(bases), L))
            if s % 3 == 0:       # cross-contig repeats: boundary cands
                at = int(rng.integers(0, L - 300))
                g = g[:at] + unit + g[at + 300:]
            seqs.append(g)
            f.write(f">c{s}\n{g}\n")
    refset = RefSet.from_fasta(str(fa))
    assert refset.nseq == nctg
    idx = build_index(refset, k, nskip)
    _ = idx.addrs
    fq = tmp_path / "r.fq"
    with open(fq, "w") as f:
        for i in range(220):
            s = int(rng.integers(0, nctg))
            pos = int(rng.integers(0, max(len(seqs[s]) - QLEN, 1)))
            r = list(seqs[s][pos:pos + QLEN].ljust(QLEN, "A"))
            if i % 2:
                for _ in range(3):
                    at = int(rng.integers(0, QLEN))
                    r[at] = "ACGT"[int(rng.integers(0, 4))]
            r = "".join(r)
            if rng.random() < 0.5:
                r = r.translate(str.maketrans("ACGT", "TGCA"))[::-1]
            f.write(f"@r{i}\n{r}\n+\n{'5' * QLEN}\n")
        for i in range(4):       # repeat-unit reads: multi-contig cands
            f.write(f"@rep{i}\n{unit[:QLEN].ljust(QLEN, 'A')}\n+\n"
                    f"{'5' * QLEN}\n")

    rand.ranseed(1)
    eng = MapEngine(refset, idx, MapParams())
    host = io.StringIO()
    assert run_pipeline_raw_fastq(eng, str(fq), host, refset)

    rand.ranseed(1)
    eng2 = MapEngine(refset, idx, MapParams())
    lane = FastLane.make(eng2, "sam", True, False, False, False)
    dev = DeviceExact.make(eng2, "sam", True, False, False, False,
                           batch=64)
    assert dev is not None and dev._host_hits
    sink = io.StringIO()
    dev.run_raw_fastq(str(fq), sink,
                      lambda a, b, c: lane.render_raw_block(a, b, c))
    assert sink.getvalue() == host.getvalue()
    # the identity must come from the device path, not blanket restage
    assert dev.n_restaged <= 24, dev.n_restaged
    assert dev.p2_used >= 50, (dev.p2_used, dev.n_restaged)


def test_checksum_matches_host_hitinfo(tmp_path):
    """The device's hit-info checksum equals the host's view (the
    runtime divergence guard the driver relies on)."""
    lib = get_lib()
    if lib is None:
        pytest.skip("native lib required")
    refset, idx, reads = _corpus(tmp_path, 5, 11, 2, nreads=16)
    eng = MapEngine(refset, idx, MapParams())
    host_rows, sels, mincovs = _host_oracle(eng, idx, lib, reads)
    _, _, _, cksum, _ = _device_run(eng, refset, idx, reads, sels,
                                    mincovs)
    for i, (rseq, rq) in enumerate(reads):
        rd = Read("x", codec.encode(rseq.encode()), rq)
        hf, hr = eng._hitinfo(rd, idx, True)
        for s_i, hi_ in ((0, hf), (1, hr)):
            assert int(cksum[i, s_i, 0]) == hi_.n_seeds
            want = int(np.sum((hi_.qoffs + 1) * hi_.nhits)) & 0x7FFFFFFF
            assert int(cksum[i, s_i, 1]) == want
