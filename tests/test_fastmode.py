"""Fast mode (device pass-1 + host traceback tail): end-to-end SAM on
the virtual CPU backend.  Checks mapping accuracy against simulated
truth and SAM well-formedness; fast mode is reference-STYLE output,
not bit-identical (the exact path covers that)."""
import io
import os

import numpy as np
import pytest

from smalt_tpu.seq.refset import RefSet
from smalt_tpu.index.table import build_index
from smalt_tpu.map.fastmode import (run_fast_pipeline, iter_fastq_batches,
                                    encode_batch, fast_mapq)


@pytest.fixture(scope="module")
def simulated(tmp_path_factory, indexed):
    refset, idx = indexed
    rng = np.random.default_rng(5)
    from smalt_tpu.seq import codec
    n = 200
    qlen = 80
    lines = []
    truth = []
    for i in range(n):
        st = int(rng.integers(0, refset.total_len - qlen))
        seg = codec.decode(refset.codes[st : st + qlen]).decode()
        seg = list(seg)
        for j in np.flatnonzero(rng.random(qlen) < 0.02):
            seg[j] = "ACGT"[int(rng.integers(0, 4))]
        s = "".join(seg)
        rev = i % 2 == 1
        if rev:
            s = s.translate(str.maketrans("ACGT", "TGCA"))[::-1]
        lines.append(f"@r{i}\n{s}\n+\n{'I' * qlen}\n")
        truth.append((st, rev))
    d = tmp_path_factory.mktemp("fast")
    fq = os.path.join(d, "reads.fq")
    with open(fq, "w") as f:
        f.write("".join(lines))
    return refset, idx, fq, truth, qlen


def test_batch_reader_roundtrip(simulated):
    refset, idx, fq, truth, qlen = simulated
    tot = 0
    for names, seqs, quals in iter_fastq_batches(fq, 64):
        assert len(names) == len(seqs) == len(quals)
        for nm, s, q in zip(names, seqs, quals):
            assert nm.startswith(b"r")
            assert len(s) == qlen and len(q) == qlen
        tot += len(names)
    assert tot == len(truth)
    arr = encode_batch([b"ACGTN"], 8)
    assert arr.tolist() == [[0, 1, 2, 3, 5, 7, 7, 7]]


def test_fast_pipeline_accuracy(simulated):
    refset, idx, fq, truth, qlen = simulated
    buf = io.StringIO()
    run_fast_pipeline(refset, idx, fq, buf, nthreads=1, batch=64)
    lines = [l for l in buf.getvalue().splitlines() if l]
    assert len(lines) == len(truth)
    offsets = refset.offsets
    name2idx = {refset.sam_name(s): s for s in range(refset.nseq)}
    ok = 0
    for line in lines:
        f = line.split("\t")
        rno = int(f[0][1:])
        flag = int(f[1])
        st, rev = truth[rno]
        if flag & 4:
            continue
        assert (flag & 16 == 16) == rev, line
        pos = int(offsets[name2idx[f[2]]]) + int(f[3]) - 1
        if abs(pos - st) <= 8:
            ok += 1
        # CIGAR consumes the full read
        import re
        span = sum(int(n) for n, op in re.findall(r"(\d+)([MIS=X])", f[5]))
        assert span == qlen, line
        assert f[11].startswith("NM:i:") and f[12].startswith("AS:i:")
    assert ok >= 0.97 * len(truth), f"only {ok}/{len(truth)} on-target"


def test_fast_mapq_shape():
    assert fast_mapq(100, 100, 100) == 0
    assert fast_mapq(100, 0, 100) == 60
    assert 0 < fast_mapq(60, 50, 100) <= 60


@pytest.fixture(scope="module")
def simulated_pairs(tmp_path_factory, indexed):
    """Proper pe pairs (insert ~300) plus some mates too corrupted for
    seeding — rescue targets."""
    refset, idx = indexed
    rng = np.random.default_rng(9)
    from smalt_tpu.seq import codec
    n, qlen, insert = 120, 80, 300
    r1, r2, truth = [], [], []
    comp = str.maketrans("ACGT", "TGCA")
    for i in range(n):
        # keep the fragment inside one reference sequence
        while True:
            st = int(rng.integers(0, refset.total_len - insert))
            sx = int(refset.find_seqidx(np.asarray([st]))[0])
            if st + insert < int(refset.offsets[sx + 1]):
                break
        frag = codec.decode(refset.codes[st : st + insert]).decode()
        a = list(frag[:qlen])
        b = list(frag[-qlen:])
        for j in np.flatnonzero(rng.random(qlen) < 0.02):
            a[j] = "ACGT"[int(rng.integers(0, 4))]
        if i % 10 == 0:
            # corrupt mate B so that no 13-mer survives (device seeding
            # fails) but SW identity stays well above the score floor:
            # rescue must still place it inside the insert window
            for j in range(0, qlen, 7):
                b[j] = "ACGT"[(("ACGT".index(b[j]) + 1) % 4)]
        a = "".join(a)
        b = "".join(b).translate(comp)[::-1]
        r1.append(f"@p{i}\n{a}\n+\n{'I' * qlen}\n")
        r2.append(f"@p{i}\n{b}\n+\n{'I' * qlen}\n")
        truth.append(st)
    d = tmp_path_factory.mktemp("fastpe")
    fq1, fq2 = os.path.join(d, "r1.fq"), os.path.join(d, "r2.fq")
    open(fq1, "w").write("".join(r1))
    open(fq2, "w").write("".join(r2))
    return refset, idx, fq1, fq2, truth, qlen, insert


def test_fast_pipeline_paired(simulated_pairs):
    refset, idx, fq1, fq2, truth, qlen, insert = simulated_pairs
    buf = io.StringIO()
    run_fast_pipeline(refset, idx, fq1, buf, nthreads=1, batch=64,
                      mates_path=fq2,
                      insert_min=0, insert_max=500)
    lines = [l.split("\t") for l in buf.getvalue().splitlines() if l]
    assert len(lines) == 2 * len(truth)
    by_read = {}
    for f in lines:
        by_read.setdefault(f[0], []).append(f)
    n_proper = n_rescued_ok = 0
    for rname, recs in by_read.items():
        assert len(recs) == 2, rname
        a = next(f for f in recs if int(f[1]) & 0x40)
        b = next(f for f in recs if int(f[1]) & 0x80)
        fa, fb = int(a[1]), int(b[1])
        assert fa & 0x1 and fb & 0x1          # paired
        i = int(rname[1:])
        if fa & 0x2:                           # proper pair
            n_proper += 1
            assert not (fa & 0x4) and not (fb & 0x4)
            assert int(a[8]) == -int(b[8]) != 0     # TLEN mirrored
            assert abs(int(a[8])) <= 500
            assert a[6] == "=" or a[6] == a[2] or a[2] == b[2]
        if i % 10 == 0 and not (fb & 0x4):
            n_rescued_ok += 1
    assert n_proper >= 0.9 * len(truth), n_proper
    # most corrupted mates should be rescued into the window
    assert n_rescued_ok >= len(truth) // 10 * 0.6


def test_fast_concordance_with_exact(simulated, indexed):
    """Fast-mode placements must agree with the exact engine's primary
    placements on well-behaved reads (measured 100% at E. coli scale;
    asserted >=98% here on the small simulated set)."""
    refset, idx, fq, truth, qlen = simulated
    buf_fast = io.StringIO()
    run_fast_pipeline(refset, idx, fq, buf_fast, nthreads=1, batch=64)
    from smalt_tpu.map.engine import MapEngine, MapParams
    from smalt_tpu.map.pipeline import run_pipeline
    from smalt_tpu.seq.io import FastqReader
    eng = MapEngine(refset, idx, MapParams())
    buf_exact = io.StringIO()
    run_pipeline(eng, FastqReader(fq), buf_exact, refset, nthreads=1,
                 seed=1)

    def parse(text):
        out = {}
        for ln in text.splitlines():
            if not ln or ln.startswith("@"):
                continue
            f = ln.split("\t")
            if int(f[1]) & 0x100:
                continue
            out[f[0]] = (int(f[1]) & 16, f[2], int(f[3]), int(f[4]), f[5])
        return out

    fp, ep = parse(buf_fast.getvalue()), parse(buf_exact.getvalue())
    conc = [(fp[k], e) for k, e in ep.items()
            if k in fp and fp[k][0] == e[0] and fp[k][1] == e[1]
            and abs(fp[k][2] - e[2]) <= 2]
    assert len(conc) >= 0.98 * len(ep), f"{len(conc)}/{len(ep)} concordant"
    # the measurable fidelity contract beyond placement (VERDICT r3 #3):
    # CIGARs must match at equal positions; mapq must track the exact
    # engine within the search-completeness cap term (the systematic
    # divergence: exact reduces the 60 cap by -10*log10 of counter
    # ratios fast seeding does not produce, results.c:1193-1197)
    cg_base = [(f, e) for f, e in conc if f[2] == e[2]]
    cg = sum(1 for f, e in cg_base if f[4] == e[4])
    assert cg >= 0.99 * max(len(cg_base), 1), \
        f"{cg}/{len(cg_base)} CIGAR-concordant"
    # mapq: the absolute values differ by the cap term (corpus-sized
    # counters), but the downstream FILTER decision must agree — bin
    # into the standard tiers a caller keys on
    def tier(q):
        return 0 if q <= 3 else (1 if q < 30 else 2)

    mqt = sum(1 for f, e in conc if tier(f[3]) == tier(e[3]))
    assert mqt >= 0.9 * len(conc), f"{mqt}/{len(conc)} mapq-tier agree"


def test_fast_mode_contig_boundary_clamp(tmp_path_factory):
    """Alignment windows must be clamped to the contig of the seed: a
    read near a contig end must never produce POS+CIGAR beyond LN or a
    record straddling into the next contig (the concatenated reference
    is contiguous in memory, so an unclamped window reads the
    neighbour's bases)."""
    import re
    rng = np.random.default_rng(17)
    bases = np.array(list(b"ACGT"), np.uint8)
    contigs = [rng.choice(bases, n).tobytes().decode()
               for n in (3000, 2500, 3500)]
    d = tmp_path_factory.mktemp("clamp")
    fa = os.path.join(d, "g.fa")
    with open(fa, "w") as f:
        for i, c in enumerate(contigs):
            f.write(f">c{i}\n")
            for j in range(0, len(c), 60):
                f.write(c[j : j + 60] + "\n")
    refset = RefSet.from_fasta(fa)
    idx = build_index(refset, 11, 2)
    qlen = 80
    recs = []
    comp = str.maketrans("ACGT", "TGCA")
    for i, c in enumerate(contigs):
        # reads ending exactly at / near the contig end, both strands
        for off in (0, 3, 7, 11):
            s = c[len(c) - qlen - off : len(c) - off]
            recs.append(f"@e{i}_{off}f\n{s}\n+\n{'I' * qlen}\n")
            recs.append(f"@e{i}_{off}r\n"
                        f"{s.translate(comp)[::-1]}\n+\n{'I' * qlen}\n")
            s2 = c[off : off + qlen]
            recs.append(f"@b{i}_{off}f\n{s2}\n+\n{'I' * qlen}\n")
    fq = os.path.join(d, "r.fq")
    open(fq, "w").write("".join(recs))
    buf = io.StringIO()
    run_fast_pipeline(refset, idx, fq, buf, nthreads=1, batch=32)
    lens = {f"c{i}": len(c) for i, c in enumerate(contigs)}
    nmapped = 0
    for ln in buf.getvalue().splitlines():
        f = ln.split("\t")
        if int(f[1]) & 4:
            continue
        nmapped += 1
        span = sum(int(n) for n, op in re.findall(r"(\d+)([MDN=X])", f[5]))
        assert int(f[3]) >= 1, ln
        assert int(f[3]) + span - 1 <= lens[f[2]], ln
    assert nmapped >= 30   # nearly all reads are perfect copies


def test_fast_pipeline_worker_pool_deterministic(simulated):
    """nthreads=2 (forked tail workers + ordered merge) must produce
    byte-identical output to the serial run — the C tails and the
    batch-number queue run inside the pool path here."""
    refset, idx, fq, truth, qlen = simulated
    import io as _io
    a = _io.StringIO()
    run_fast_pipeline(refset, idx, fq, a, nthreads=1, batch=64)
    b = _io.StringIO()
    run_fast_pipeline(refset, idx, fq, b, nthreads=2, batch=64)
    assert a.getvalue() == b.getvalue()
