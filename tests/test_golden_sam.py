"""Golden end-to-end tests: SAM output must be bit-identical to reference
SMALT 0.7.6 run as `smalt index -k 13 -s 4; smalt map -f sam -r 1` on the
bundled genome + simulated reads (fixtures generated with misc/simread).

This is the analogue of the reference's Python test drivers
(test/mthread_test.py, test/cigar_test.py)."""
import gzip
import io
import os

import pytest

from smalt_tpu.cli import main


def _read_lines(path):
    if path.endswith(".gz"):
        with gzip.open(path, "rt") as f:
            return [l for l in f.read().splitlines() if not l.startswith("@")]
    with open(path) as f:
        return [l for l in f.read().splitlines() if not l.startswith("@")]


@pytest.fixture(scope="module")
def index_prefix(tmp_path_factory, data_dir):
    d = tmp_path_factory.mktemp("idx")
    pref = str(d / "idx")
    assert main(["index", "-k", "13", "-s", "4", pref,
                 os.path.join(data_dir, "genome.fa")]) == 0
    return pref


def test_single_end_bit_identical(index_prefix, data_dir, tmp_path):
    out = str(tmp_path / "se.sam")
    assert main(["map", "-f", "sam", "-r", "1", "-o", out, index_prefix,
                 os.path.join(data_dir, "reads_se.fq.gz")]) == 0
    got = _read_lines(out)
    want = _read_lines(os.path.join(data_dir, "golden_se_r1.sam.gz"))
    assert len(got) == len(want) == 2000
    assert got == want


def test_paired_end_bit_identical(index_prefix, data_dir, tmp_path):
    out = str(tmp_path / "pe.sam")
    assert main(["map", "-f", "sam", "-r", "1", "-o", out, index_prefix,
                 os.path.join(data_dir, "reads_pe_1.fq"),
                 os.path.join(data_dir, "reads_pe_2.fq")]) == 0
    got = _read_lines(out)
    want = _read_lines(os.path.join(data_dir, "golden_pe_r1.sam"))
    assert len(got) == len(want) == 240
    assert got == want


@pytest.fixture(scope="module")
def index600_prefix(tmp_path_factory, data_dir):
    """600-sequence genome: triggers the whole-genome (non seq-by-seq)
    path with boundary-crossing reads (reference regime: >512 sequences,
    smalt.c:65-68; test/xali_test.py)."""
    import gzip as _gz
    d = tmp_path_factory.mktemp("idx600")
    fa = str(d / "genome600.fa")
    with _gz.open(os.path.join(data_dir, "genome600.fa.gz"), "rb") as f:
        open(fa, "wb").write(f.read())
    pref = str(d / "idx600")
    assert main(["index", "-k", "13", "-s", "4", pref, fa]) == 0
    return pref


def test_whole_genome_boundary_split_se(index600_prefix, data_dir, tmp_path):
    out = str(tmp_path / "se600.sam")
    assert main(["map", "-f", "sam", "-r", "1", "-o", out, index600_prefix,
                 os.path.join(data_dir, "reads_se.fq.gz")]) == 0
    got = _read_lines(out)
    want = _read_lines(os.path.join(data_dir, "golden600_se_r1.sam.gz"))
    assert len(got) == len(want) == 2000
    assert got == want


def test_whole_genome_boundary_split_pe(index600_prefix, data_dir, tmp_path):
    out = str(tmp_path / "pe600.sam")
    assert main(["map", "-f", "sam", "-r", "1", "-o", out, index600_prefix,
                 os.path.join(data_dir, "reads_pe_1.fq"),
                 os.path.join(data_dir, "reads_pe_2.fq")]) == 0
    got = _read_lines(out)
    want = _read_lines(os.path.join(data_dir, "golden600_pe_r1.sam"))
    assert got == want


def test_split_read_mode(index_prefix, data_dir, tmp_path):
    """-p split-read mapping (reference splitReads_test.py analogue):
    chimeric reads report primary + NOTPRIMARY partial alignments."""
    out = str(tmp_path / "split.sam")
    assert main(["map", "-p", "-f", "sam", "-r", "1", "-o", out, index_prefix,
                 os.path.join(data_dir, "reads_split.fq")]) == 0
    got = _read_lines(out)
    want = _read_lines(os.path.join(data_dir, "golden_split.sam.gz"))
    assert got == want


def test_split_read_mode_paired(index_prefix, data_dir, tmp_path):
    """Paired -p: the pair flow's mapSecondary passes + per-segment
    PARTIAL report chain (rmap.c:2099-2110, resultpairs.c:1293-1310),
    golden minted with the reference binary."""
    out = str(tmp_path / "psplit.sam")
    assert main(["map", "-p", "-f", "sam", "-r", "1", "-o", out,
                 index_prefix,
                 os.path.join(data_dir, "reads_pe_1.fq"),
                 os.path.join(data_dir, "reads_pe_2.fq")]) == 0
    got = _read_lines(out)
    want = _read_lines(os.path.join(data_dir, "golden_pe_r1_split.sam.gz"))
    assert got == want


def test_sample_histogram(index_prefix, data_dir, tmp_path):
    """smalt sample: exhaustive-mode pair mapping + Gaussian-smoothed
    insert histogram, byte-identical file (sample_test.py analogue)."""
    out = str(tmp_path / "hist.txt")
    assert main(["sample", "-o", out, index_prefix,
                 os.path.join(data_dir, "reads_pe_1.fq"),
                 os.path.join(data_dir, "reads_pe_2.fq")]) == 0
    got = open(out).read().splitlines()
    want = open(os.path.join(data_dir, "golden_sample.txt")).read().splitlines()
    assert got == want


def test_cigar_output_format(index_prefix, data_dir, tmp_path):
    """-f cigar output lines (ouform_cigar_test.py analogue): spot-check
    the first mapped read against the reference's cigar line format."""
    out = str(tmp_path / "out.cig")
    assert main(["map", "-f", "cigar", "-r", "1", "-o", out, index_prefix,
                 os.path.join(data_dir, "reads_se.fq.gz")]) == 0
    first = open(out).readline()
    assert first == ("cigar:S:54 rd_000000000_chr2_000007709_1_R_100m "
                     "100 1 - chr2 7709 7808 + 100 M 100 \n")


def test_cigar_output_format_paired(index_prefix, data_dir, tmp_path):
    """Regression: a paired -f cigar run must emit cigar lines, not
    SAM (bug found when ssaha joined the single-end C lane; the paired
    C lane now renders cigar/ssaha natively via flrep_write)."""
    out = str(tmp_path / "out.cig")
    assert main(["map", "-f", "cigar", "-r", "1", "-o", out, index_prefix,
                 os.path.join(data_dir, "reads_pe_1.fq"),
                 os.path.join(data_dir, "reads_pe_2.fq")]) == 0
    lines = open(out).read().splitlines()
    assert all(ln.startswith("cigar:") for ln in lines), lines[0]
    assert len(lines) == 240


def test_ssaha_output_format(index_prefix, data_dir, tmp_path):
    out = str(tmp_path / "out.ssaha")
    assert main(["map", "-f", "ssaha", "-r", "1", "-o", out, index_prefix,
                 os.path.join(data_dir, "reads_pe_1.fq"),
                 os.path.join(data_dir, "reads_pe_2.fq")]) == 0
    first = open(out).readline()
    assert first.startswith("alignment:")
    assert len(open(out).read().splitlines()) == 240


def test_gff2_output_format(index_prefix, data_dir, tmp_path):
    """The reference binary segfaults on -f gff (upstream bug in its
    DiffBlocks path); we emit the documented format (report.c:205-208)."""
    out = str(tmp_path / "out.gff")
    assert main(["map", "-f", "gff", "-r", "1", "-o", out, index_prefix,
                 os.path.join(data_dir, "reads_se.fq.gz")]) == 0
    first = open(out).readline()
    assert first.startswith("gff: ") and "\tSMALT\tsimilarity\t" in first
    assert " Align " in first


VARIANTS = {
    "d5": ["-d", "5"],
    "dm1": ["-d", "-1"],
    "w": ["-w"],
    "x": ["-x"],
    "m30": ["-m", "30"],
    "S2m3": ["-S", "match=2,subst=-3"],
    "q5": ["-q", "5"],
    "y09": ["-y", "0.9"],
}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_option_variants_bit_identical(index_prefix, data_dir, tmp_path,
                                       name):
    """Flag-variant parity: goldens minted from the reference binary
    with `map -f sam -r 1 <flags>` on the same index/reads."""
    out = str(tmp_path / f"{name}.sam")
    args = (["map", "-f", "sam", "-r", "1"] + VARIANTS[name] +
            ["-o", out, index_prefix,
             os.path.join(data_dir, "reads_se.fq.gz")])
    assert main(args) == 0
    got = _read_lines(out)
    want = _read_lines(os.path.join(data_dir,
                                    f"golden_se_r1_{name}.sam.gz"))
    assert len(got) == len(want) == 2000
    assert got == want


PE_VARIANTS = {
    "mp": ["-l", "mp"],
    "pp": ["-l", "pp"],
    "i300j100": ["-i", "300", "-j", "100"],
    "x": ["-x"],
    "d0": ["-d", "0"],
}


@pytest.mark.parametrize("name", sorted(PE_VARIANTS))
def test_pe_option_variants_bit_identical(index_prefix, data_dir, tmp_path,
                                          name):
    """Paired-end flag parity: library types (mate-pair, same-strand),
    insert bounds, exhaustive mode."""
    out = str(tmp_path / f"pe_{name}.sam")
    args = (["map", "-f", "sam", "-r", "1"] + PE_VARIANTS[name] +
            ["-o", out, index_prefix,
             os.path.join(data_dir, "reads_pe_1.fq"),
             os.path.join(data_dir, "reads_pe_2.fq")])
    assert main(args) == 0
    got = _read_lines(out)
    want = _read_lines(os.path.join(data_dir,
                                    f"golden_pe_r1_{name}.sam.gz"))
    assert len(got) == len(want) == 240
    assert got == want


FORMAT_VARIANTS = {
    "cigar": ["-f", "cigar"],
    "ssaha": ["-f", "ssaha"],
    "samclip": ["-f", "sam:clip"],
    "samx": ["-f", "sam:x"],
    "c05x": ["-f", "sam", "-x", "-c", "0.5"],
}


@pytest.mark.parametrize("name", sorted(FORMAT_VARIANTS))
def test_format_variants_bit_identical(index_prefix, data_dir, tmp_path,
                                       name):
    """Output-format/modifier parity: CIGAR lines, SSAHA lines, hard
    clips, X-mismatch cigars, exhaustive search with a cover floor."""
    out = str(tmp_path / f"{name}.out")
    args = (["map", "-r", "1"] + FORMAT_VARIANTS[name] +
            ["-o", out, index_prefix,
             os.path.join(data_dir, "reads_se.fq.gz")])
    assert main(args) == 0
    got = _read_lines(out)
    want = _read_lines(os.path.join(data_dir,
                                    f"golden_se_r1_{name}.out.gz"))
    assert len(got) == len(want) == 2000
    assert got == want


def test_pe_insert_histogram_weighting(index_prefix, data_dir, tmp_path):
    """map -g <histogram>: pair likelihoods weighted by the sampled
    insert distribution (insert.c read-back)."""
    out = str(tmp_path / "pe_g.sam")
    args = ["map", "-f", "sam", "-r", "1",
            "-g", os.path.join(data_dir, "golden_sample.txt"),
            "-o", out, index_prefix,
            os.path.join(data_dir, "reads_pe_1.fq"),
            os.path.join(data_dir, "reads_pe_2.fq")]
    assert main(args) == 0
    got = _read_lines(out)
    want = _read_lines(os.path.join(data_dir, "golden_pe_r1_g.sam.gz"))
    assert len(got) == len(want) == 240
    assert got == want


def test_ecoli_scale_bit_identical(data_dir, tmp_path):
    """E. coli-scale parity (BASELINE config 2): 10,000 reads over a
    4.6 Mb genome at k13 s2 through the full native stack.  Inputs are
    regenerated deterministically from the bench generators (numpy
    Generator bit streams are stable); only the reference's SAM is a
    fixture."""
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import numpy as np
    import bench as B

    rng = np.random.default_rng(123)
    genome = B._gen_genome(rng)
    fa = str(tmp_path / "g.fa")
    with open(fa, "w") as f:
        f.write(">ecoli_sim\n")
        for i in range(0, len(genome), 60):
            f.write(genome[i : i + 60] + "\n")
    reads, _truth = B._gen_reads(rng, genome, 10000)
    fq = str(tmp_path / "r.fq")
    with open(fq, "w") as f:
        for i, s in enumerate(reads):
            f.write(f"@r{i}\n{s}\n+\n{'5' * len(s)}\n")
    pref = str(tmp_path / "idx")
    assert main(["index", "-k", "13", "-s", "2", pref, fa]) == 0
    out = str(tmp_path / "out.sam")
    assert main(["map", "-f", "sam", "-r", "1", "-o", out, pref, fq]) == 0
    got = _read_lines(out)
    want = _read_lines(os.path.join(data_dir, "golden_ecoli_r1.sam.gz"))
    assert len(got) == len(want) == 10000
    assert got == want


def test_ecoli_scale_paired_bit_identical(data_dir, tmp_path):
    """Paired-end E. coli-scale parity (BASELINE config 3): 3,000
    2x150 bp pairs (insert ~N(400,40), 1% errors) — exercises mate
    rescue and restricted re-mapping at scale.  Inputs regenerate
    deterministically; the reference SAM is the fixture."""
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import numpy as np
    import bench as B

    rng = np.random.default_rng(777)
    genome = B._gen_genome(rng)
    fa = str(tmp_path / "g.fa")
    with open(fa, "w") as f:
        f.write(">ecoli_sim\n")
        for i in range(0, len(genome), 60):
            f.write(genome[i : i + 60] + "\n")
    comp = str.maketrans("ACGT", "TGCA")
    N, RL = 3000, 150
    fq1, fq2 = str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq")
    with open(fq1, "w") as f1, open(fq2, "w") as f2:
        for i in range(N):
            ins = int(rng.normal(400, 40))
            ins = max(2 * RL + 10, min(600, ins))
            st = int(rng.integers(0, len(genome) - ins))
            frag = genome[st : st + ins]
            a = list(frag[:RL])
            b = list(frag[-RL:])
            for arr in (a, b):
                for j in np.flatnonzero(rng.random(RL) < 0.01):
                    arr[j] = "ACGT"[int(rng.integers(0, 4))]
            f1.write(f"@p{i}\n{''.join(a)}\n+\n{'5' * RL}\n")
            f2.write(f"@p{i}\n{''.join(b).translate(comp)[::-1]}\n+\n"
                     f"{'5' * RL}\n")
    pref = str(tmp_path / "idx")
    assert main(["index", "-k", "13", "-s", "2", pref, fa]) == 0
    out = str(tmp_path / "out.sam")
    assert main(["map", "-f", "sam", "-r", "1", "-o", out, pref,
                 fq1, fq2]) == 0
    got = _read_lines(out)
    want = _read_lines(os.path.join(data_dir, "golden_ecoli_pe_r1.sam.gz"))
    assert len(got) == len(want) == 6000
    assert got == want


def test_alignment_display_bit_identical(index_prefix, data_dir, tmp_path):
    """-a (explicit alignment display, report.c printExplicitAlignment):
    golden minted from the reference binary — every QUERY/MATCH/SUBJCT
    block byte-identical, interleaved with the SAM records."""
    out = str(tmp_path / "a.out")
    assert main(["map", "-f", "sam", "-r", "1", "-a", "-o", out,
                 index_prefix,
                 os.path.join(data_dir, "reads_se.fq.gz")]) == 0
    got = _read_lines(out)
    want = _read_lines(os.path.join(data_dir, "golden_se_r1_a.out.gz"))
    assert len(got) == len(want) == 22000
    assert got == want


def test_negative_seed_bit_identical(index_prefix, data_dir, tmp_path):
    """-r -1: reads with multiple best mappings report as unmapped (no
    drand48 selection; rmap.c RSLTFLG_SELECT clear)."""
    out = str(tmp_path / "rm1.sam")
    assert main(["map", "-f", "sam", "-r", "-1", "-o", out, index_prefix,
                 os.path.join(data_dir, "reads_se.fq.gz")]) == 0
    got = _read_lines(out)
    want = _read_lines(os.path.join(data_dir, "golden_se_rm1.sam.gz"))
    assert len(got) == len(want) == 2000
    assert got == want


@pytest.mark.parametrize("fmt", ["cigar", "ssaha"])
def test_pe_text_formats_bit_identical(index_prefix, data_dir, tmp_path,
                                       fmt):
    """Paired cigar/ssaha lines (qnames keep /1 /2, per-record CONTIG
    labels) against reference-minted goldens."""
    out = str(tmp_path / f"pe.{fmt}")
    assert main(["map", "-f", fmt, "-r", "1", "-o", out, index_prefix,
                 os.path.join(data_dir, "reads_pe_1.fq"),
                 os.path.join(data_dir, "reads_pe_2.fq")]) == 0
    got = _read_lines(out)
    want = _read_lines(os.path.join(data_dir,
                                    f"golden_pe_r1_{fmt}.out.gz"))
    assert len(got) == len(want) == 240
    assert got == want


def test_golden_shortmate_pairs(data_dir, tmp_path):
    """Pairs with very short mates (below the k-mer word, between the
    word and the engine threshold ktup+nskip-1, and between that and
    the OUTPUT filter's raw menu default of 18) against the reference
    binary's output.  Pins the reference quirk that the output filter
    keeps the menu constant 18 while the engine maps down to
    ktup+nskip-1 (smalt.c:490 vs 608), and that one-sided-ShortSeq
    pairs still run the whole pair flow including the filters
    (rmap.c:1836-2110).  Fixture minted from reference SMALT 0.7.6:
    `smalt index -k 11 -s 2; smalt map -f sam -r 1`."""
    pref = str(tmp_path / "idx")
    assert main(["index", "-k", "11", "-s", "2", pref,
                 os.path.join(data_dir, "shortmate_genome.fa")]) == 0
    out = str(tmp_path / "sm.sam")
    assert main(["map", "-f", "sam", "-r", "1", "-o", out, pref,
                 os.path.join(data_dir, "shortmate_1.fq"),
                 os.path.join(data_dir, "shortmate_2.fq")]) == 0
    got = _read_lines(out)
    want = _read_lines(os.path.join(data_dir, "golden_shortmate_pe.sam"))
    assert len(got) == len(want) == 20
    assert got == want


def test_golden_shortmate_pairs_python_oracle(data_dir, tmp_path,
                                              monkeypatch):
    """The same corpus through the pure-Python engine (the lane
    fallback oracle) — the one-sided-ShortSeq branch must apply the
    output filters exactly like the reference."""
    monkeypatch.setenv("SMALT_TPU_NO_FASTLANE", "1")
    pref = str(tmp_path / "idx")
    assert main(["index", "-k", "11", "-s", "2", pref,
                 os.path.join(data_dir, "shortmate_genome.fa")]) == 0
    out = str(tmp_path / "sm.sam")
    assert main(["map", "-f", "sam", "-r", "1", "-o", out, pref,
                 os.path.join(data_dir, "shortmate_1.fq"),
                 os.path.join(data_dir, "shortmate_2.fq")]) == 0
    got = _read_lines(out)
    want = _read_lines(os.path.join(data_dir, "golden_shortmate_pe.sam"))
    assert got == want
