"""Fast-mode paired-end upgrades (VERDICT r1 item 10): mp/pp library
geometry via the shared testProperPair, and the pair-marginal mapq
elevation of score-tied mates inside unique proper pairs."""
import io
import os

import numpy as np
import pytest

from smalt_tpu.map.fastmode import run_fast_pipeline
from smalt_tpu.results.pairs import (LIB_MATEPAIR, LIB_PAIREDEND,
                                     LIB_SAMESTRAND)

QLEN = 80
INSERT = 300
COMP = str.maketrans("ACGT", "TGCA")


def _write_world(tmp, rng, genome):
    fa = os.path.join(tmp, "g.fa")
    with open(fa, "w") as f:
        f.write(">g\n")
        for j in range(0, len(genome), 60):
            f.write(genome[j : j + 60] + "\n")
    from smalt_tpu.seq.refset import RefSet
    from smalt_tpu.index.table import build_index
    refset = RefSet.from_fasta(fa)
    idx = build_index(refset, 11, 2)
    return refset, idx


def _pairs_fastq(tmp, frags, orient):
    """orient: 'pe' (fwd + revcomp), 'mp' (revcomp + fwd),
    'pp' (fwd + fwd)."""
    r1, r2 = [], []
    for i, frag in enumerate(frags):
        a = frag[:QLEN]
        b = frag[-QLEN:]
        if orient == "pe":
            b = b.translate(COMP)[::-1]
        elif orient == "mp":
            a = a.translate(COMP)[::-1]
        r1.append(f"@p{i}\n{a}\n+\n{'I' * QLEN}\n")
        r2.append(f"@p{i}\n{b}\n+\n{'I' * QLEN}\n")
    fq1 = os.path.join(tmp, f"{orient}_1.fq")
    fq2 = os.path.join(tmp, f"{orient}_2.fq")
    open(fq1, "w").write("".join(r1))
    open(fq2, "w").write("".join(r2))
    return fq1, fq2


def _map(refset, idx, fq1, fq2, libcode, ihist=None):
    buf = io.StringIO()
    run_fast_pipeline(refset, idx, fq1, buf, nthreads=1, batch=32,
                      mates_path=fq2, insert_min=0,
                      insert_max=500, libcode=libcode, ihist=ihist)
    recs = {}
    for ln in buf.getvalue().splitlines():
        f = ln.split("\t")
        recs.setdefault(f[0], []).append(f)
    return recs


@pytest.mark.parametrize("orient,libcode,wrong",
                         [("pe", LIB_PAIREDEND, LIB_MATEPAIR),
                          ("mp", LIB_MATEPAIR, LIB_PAIREDEND),
                          ("pp", LIB_SAMESTRAND, LIB_PAIREDEND)])
def test_library_geometry(tmp_path, orient, libcode, wrong):
    rng = np.random.default_rng(53)
    genome = "".join("ACGT"[i] for i in rng.integers(0, 4, 20000))
    refset, idx = _write_world(str(tmp_path), rng, genome)
    frags = []
    for i in range(20):
        st = int(rng.integers(0, len(genome) - INSERT))
        frags.append(genome[st : st + INSERT])
    fq1, fq2 = _pairs_fastq(str(tmp_path), frags, orient)

    good = _map(refset, idx, fq1, fq2, libcode)
    n_proper = sum(1 for recs in good.values()
                   if all(int(f[1]) & 0x2 for f in recs))
    assert n_proper >= 18, f"{orient}: only {n_proper}/20 proper"

    bad = _map(refset, idx, fq1, fq2, wrong)
    n_improper = sum(1 for recs in bad.values()
                     if not any(int(f[1]) & 0x2 for f in recs))
    assert n_improper >= 18, f"{orient} vs wrong lib: {n_improper}"


def test_tied_mate_elevation(tmp_path):
    """Mate B sits in an exact two-copy repeat (tie -> mapq 0 alone);
    its proper pair with a confidently-mapped A must raise B's mapq to
    the pair marginal, bounded by A's mapq."""
    rng = np.random.default_rng(59)
    uniq = "".join("ACGT"[i] for i in rng.integers(0, 4, 12000))
    dup = "".join("ACGT"[i] for i in rng.integers(0, 4, 400))
    # copy 1 at INSERT-QLEN after a unique anchor region; copy 2 far away
    genome = uniq[:4000] + dup + uniq[4000:8000] + dup + uniq[8000:]
    refset, idx = _write_world(str(tmp_path), rng, genome)
    # fragment: A in unique region just before copy 1, B inside copy 1
    frag_start = 4000 - (INSERT - QLEN) + 100
    frag = genome[frag_start : frag_start + INSERT]
    fq1, fq2 = _pairs_fastq(str(tmp_path), [frag] * 4, "pe")
    recs = _map(refset, idx, fq1, fq2, LIB_PAIREDEND)
    for name, lines in recs.items():
        a = next(f for f in lines if int(f[1]) & 0x40)
        b = next(f for f in lines if int(f[1]) & 0x80)
        assert int(a[1]) & 0x2, f"{name} not proper"
        assert int(a[4]) >= 20, f"anchor mapq low: {a[4]}"
        assert 4 <= int(b[4]) <= int(a[4]), \
            f"tied mate not elevated into (3, anchor]: {b[4]} vs {a[4]}"
