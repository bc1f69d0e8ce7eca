"""C fast-lane differential tests: the native block engine
(native/fastlane.c) must be byte-identical to the Python path
(SMALT_TPU_NO_FASTLANE=1) on every covered mode, including the RNG
stream consumed by random tie selection."""
import io
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_map(tmp_path, args, no_lane):
    env = dict(os.environ)
    if no_lane:
        env["SMALT_TPU_NO_FASTLANE"] = "1"
    else:
        env.pop("SMALT_TPU_NO_FASTLANE", None)
    out = str(tmp_path / ("py.sam" if no_lane else "fl.sam"))
    cmd = [sys.executable, "-c",
           "import sys; sys.path.insert(0, %r); "
           "from smalt_tpu.cli import main; "
           "sys.exit(main(%r))" % (REPO, args + ["-o", out])]
    r = subprocess.run(cmd, env=env, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    with open(out) as f:
        return [l for l in f.read().splitlines() if not l.startswith("@")]


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    """Genome with a planted tandem repeat (tie-break + RNG coverage)
    plus reads: clean, erroneous, low-quality, repeat-ambiguous,
    too-short, and all-N."""
    rng = np.random.default_rng(99)
    bases = np.array(list(b"ACGT"), np.uint8)
    seg = rng.choice(bases, 3000).tobytes().decode()
    g1 = rng.choice(bases, 30000).tobytes().decode() + seg + \
        rng.choice(bases, 5000).tobytes().decode() + seg
    g2 = rng.choice(bases, 20000).tobytes().decode()
    d = tmp_path_factory.mktemp("fl")
    fa = str(d / "g.fa")
    with open(fa, "w") as f:
        for nm, g in (("chrA", g1), ("chrB", g2)):
            f.write(f">{nm}\n")
            for i in range(0, len(g), 60):
                f.write(g[i : i + 60] + "\n")
    genome = g1
    reads = []
    comp = str.maketrans("ACGT", "TGCA")
    for i in range(400):
        ql = 60 + int(rng.integers(0, 60))
        if i % 7 == 0:      # inside the repeat -> ambiguous, consumes RNG
            st = 30000 + int(rng.integers(0, 3000 - ql))
        else:
            st = int(rng.integers(0, len(genome) - ql))
        s = list(genome[st : st + ql])
        for j in np.flatnonzero(rng.random(ql) < 0.03):
            s[j] = "ACGT"[int(rng.integers(0, 4))]
        s = "".join(s)
        if i % 2:
            s = s.translate(comp)[::-1]
        qual = "".join(chr(33 + int(q)) for q in rng.integers(2, 41, ql))
        reads.append((f"r{i}", s, qual))
    for i in range(40):     # chimeric reads: the -p split-mode case
        la = 40 + int(rng.integers(0, 30))
        lb = 40 + int(rng.integers(0, 30))
        sa = int(rng.integers(0, len(genome) - la))
        sb = int(rng.integers(0, len(g2) - lb))
        s = genome[sa : sa + la] + g2[sb : sb + lb]
        if i % 2:
            s = s.translate(comp)[::-1]
        reads.append((f"chim{i}", s, "5" * len(s)))
    reads.append(("tiny", "ACGTAC", "IIIIII"))           # ShortSeq path
    reads.append(("allN", "N" * 80, "I" * 80))           # no seeds
    fq = str(d / "r.fq")
    with open(fq, "w") as f:
        for nm, s, q in reads:
            f.write(f"@{nm}\n{s}\n+\n{q}\n")
    pref = str(d / "idx")
    r = subprocess.run([sys.executable, "-c",
                        "import sys; sys.path.insert(0, %r); "
                        "from smalt_tpu.cli import main; "
                        "sys.exit(main(['index', '-k', '11', '-s', '3', "
                        "%r, %r]))" % (REPO, pref, fa)],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    return pref, fq


@pytest.mark.parametrize("extra", [
    [],                                  # default: BEST|SINGLE|RANDSEL
    ["-r", "-1"],                        # no random selection
    ["-m", "25"],                        # score floor
    ["-q", "10"],                        # base-quality seed threshold
    ["-y", "0.85"],                      # identity filter
    ["-S", "match=2,subst=-3,gapopen=-5,gapext=-4"],
    ["-f", "sam:clip"],                  # hard clip
    ["-f", "sam:x"],                     # X mismatch CIGAR
    ["-c", "0.5"],                       # min cover
    ["-p"],                              # split-read (secondary pass)
    ["-p", "-f", "cigar"],               # split + cigar lines
    ["-f", "ssaha"],                     # ssaha alignment lines
    ["-p", "-f", "ssaha"],               # split + ssaha
    ["-f", "gff"],                       # gff2 Align blocks
    ["-d", "0"],                         # all best mappings (fix_primary)
    ["-d", "5"],                         # scorediff multi-report
    ["-d", "-1"],                        # all above -m threshold
    ["-d", "5", "-m", "30"],             # scorediff + score floor
    ["-a"],                              # explicit alignment display
    ["-a", "-f", "cigar"],               # display after cigar lines
    ["-a", "-d", "5"],                   # display on multi-reports
])
def test_fastlane_matches_python(fixture_dir, tmp_path, extra):
    pref, fq = fixture_dir
    base = ["map", "-f", "sam", "-r", "1"]
    args = base + extra + [pref, fq]
    if "-f" in extra:
        args = ["map", "-r", "1"] + extra + [pref, fq]
    got_fl = _run_map(tmp_path, args, no_lane=False)
    got_py = _run_map(tmp_path, args, no_lane=True)
    assert got_fl == got_py


def test_fastlane_actually_engaged(fixture_dir):
    """Guard: the lane must report itself usable for the default mode
    (otherwise the differential tests silently compare python/python)."""
    sys.path.insert(0, REPO)
    from smalt_tpu.cli import _build_engine, _map_argparser
    from smalt_tpu.map.fastlane import FastLane
    pref, fq = fixture_dir
    a = _map_argparser("t").parse_args(["-r", "1", pref, fq])
    engine, refset, idx = _build_engine(a, [])
    lane = FastLane.make(engine, "sam", True, False, False, False)
    assert lane is not None


def test_device_pass1_matches_host(fixture_dir, tmp_path):
    """--device-pass1 (pass-1 candidate scoring on the accelerator,
    exact pass-2 on host) must be byte-identical to the host lane —
    the converged-engine requirement: one algorithm, two executions.
    The subprocess inherits JAX_PLATFORMS=cpu from conftest."""
    pref, fq = fixture_dir
    out = str(tmp_path / "dev.sam")
    cmd = [sys.executable, "-c",
           "import sys; sys.path.insert(0, %r); "
           "from smalt_tpu.cli import main; "
           "sys.exit(main(['map', '-f', 'sam', '-r', '1', "
           "'--device-pass1', %r, %r, '-o', %r]))" % (REPO, pref, fq, out)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    with open(out) as f:
        got_dev = [l for l in f.read().splitlines() if not l.startswith("@")]
    got_py = _run_map(tmp_path, ["map", "-f", "sam", "-r", "1", pref, fq],
                      no_lane=True)
    assert got_dev == got_py


def test_gapless_shortcut_stress(tmp_path):
    """Pass-2 gapless shortcut (fl_read_finish): perfect-copy reads in
    adversarial placements — tandem duplications (two exact occurrences
    in one window: must fall through to the DP), occurrences mid-array,
    reads with N, and plain unique perfects — stay byte-identical to
    the no-fastlane oracle."""
    rng = np.random.default_rng(99)
    g = "".join("ACGT"[int(x)] for x in rng.integers(0, 4, 40_000))
    unit = g[1000:1100]
    # tandem pair 60 apart (both copies inside one candidate window)
    g = g[:5000] + unit + g[5000:5060] + unit + g[5060:]
    # triple array of an 80-mer
    u2 = g[9000:9080]
    g = g[:12000] + u2 + u2 + u2 + g[12000:]
    fa = str(tmp_path / "g.fa")
    with open(fa, "w") as f:
        f.write(">tg\n")
        for i in range(0, len(g), 60):
            f.write(g[i : i + 60] + "\n")
    comp = str.maketrans("ACGT", "TGCA")
    reads = [("dup", unit), ("dup_rc", unit.translate(comp)[::-1]),
             ("arr", u2), ("arr2", (u2 + u2)[:100]),
             ("uniq", g[20000:20100]),
             ("uniq_rc", g[25000:25100].translate(comp)[::-1]),
             ("withN", g[30000:30050] + "N" + g[30051:30100]),
             ("edge", g[60:160]), ("tail", g[-160:-60])]
    for i in range(40):   # random perfect + 1-mismatch reads
        st = int(rng.integers(0, len(g) - 120))
        s = g[st : st + 100]
        if i % 3 == 1:
            p = int(rng.integers(0, 100))
            s = s[:p] + "ACGT"[int(rng.integers(0, 4))] + s[p + 1:]
        if i % 2:
            s = s.translate(comp)[::-1]
        reads.append((f"r{i}", s))
    fq = str(tmp_path / "r.fq")
    with open(fq, "w") as f:
        for nm, s in reads:
            f.write(f"@{nm}\n{s}\n+\n{'I' * len(s)}\n")
    pref = str(tmp_path / "idx")
    r = subprocess.run([sys.executable, "-c",
                        "import sys; sys.path.insert(0, %r); "
                        "from smalt_tpu.cli import main; "
                        "sys.exit(main(['index', '-k', '11', '-s', '2', "
                        "%r, %r]))" % (REPO, pref, fa)],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    args = ["map", "-f", "sam", "-r", "1", pref, fq]
    got_fl = _run_map(tmp_path, args, no_lane=False)
    got_py = _run_map(tmp_path, args, no_lane=True)
    assert got_fl == got_py
