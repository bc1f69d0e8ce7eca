#!/usr/bin/env python3
"""Smoke run of smalt_tpu on one NVIDIA GPU, through the CLI a user
calls, at the scale of a bacterial resequencing run.

    python chip_smoke.py          # one card: phases 1-4
    python chip_smoke.py --four   # four cards: phase 1 and the mesh phase

Phases:
  1. device   nvidia-smi's name and power limit, jax.devices(); exits
              non-zero unless the platform is "gpu".
  2. scorers  the `gpu`-marked tests (tests/test_gpu_scorers.py): the
              device scorers against the host C kernel and against the
              same call on the CPU, tolerance 0.
  3. golden   --device-exact, --device-pass1, --device-exact with device
              pass 2 (SMALT_DX_P2=1) and paired --device-exact on the
              bundled fixtures, diffed against the reference SMALT 0.7.6
              golden SAM (index -k 13 -s 4, map -r 1): must be empty.
  4. ecoli    a seeded 4.6 Mb genome with planted repeats (bench.py),
              index -k 13 -s 2 (the direct k=13 table, the position list
              and the reference live on the card), then --fast SE
              (100,000 x 100 bp), --fast PE (20,000 x 2x150),
              --device-exact SE and PE byte-compared with the pure-C
              lane, and --fast on 1,000 reads of 1,500 bp.  Each run goes
              twice: cold (compile included) and warm.
  --four      the phase-4 SE and PE corpora through --fast on --mesh 4,1,
              --mesh 2,2 and the automatic dp over all visible devices,
              each byte-compared with one card.

Every number printed names the card and its power limit.  Any failed
phase makes the run exit 1 without the result line; the last line of a
passing run is one JSON object naming the device.  Everything runs in
this one process, so only one process holds the card.
"""
import argparse
import contextlib
import gzip
import json
import os
import shutil
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "tests", "data")
WORK = os.path.join(HERE, ".smoke_work")
CARD = "card not identified"
# phase-4 corpus: reads of a bacterial resequencing run
N_SE = 100_000          # single-end 100 bp reads
N_PAIRS = 20_000        # 2x150 pairs
N_LONG, LONG_LEN = 1000, 1500
FAST_BATCH = 4096       # the CLI's --fast batch (SMALT_FAST_BATCH)


def say(msg):
    print(msg, flush=True)


def card_info():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        raise RuntimeError("nvidia-smi failed: " + r.stderr.strip())
    return r.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def env_set(env):
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def cli(*argv):
    from smalt_tpu.cli import main
    rc = main([str(a) for a in argv])
    if rc != 0:
        raise RuntimeError(f"smalt_tpu {' '.join(map(str, argv))} -> {rc}")


def body_lines(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return [ln for ln in f.read().splitlines()
                if ln and not ln.startswith("@")]


class DeviceUse:
    """Records which device lanes a CLI run really took, so a golden
    diff cannot pass on a silent host fallback."""

    def __init__(self):
        from smalt_tpu.map import fastlane
        self.fl = fastlane
        self.used = []
        self.p2 = 0

    def __enter__(self):
        fl = self.fl
        self.saved = (fl.DevicePass1.run_raw_fastq,
                      fl.DeviceExact.run_raw_fastq,
                      fl.DeviceExact.run_raw_pairs)
        dp1, dxs, dxp = self.saved
        use = self

        def dp1_run(dev, *a, **k):
            use.used.append("device-pass1")
            return dp1(dev, *a, **k)

        def dxs_run(dev, *a, **k):
            use.used.append("device-exact")
            r = dxs(dev, *a, **k)
            use.p2 += dev.p2_used
            return r

        def dxp_run(dev, *a, **k):
            use.used.append("device-exact-pe")
            return dxp(dev, *a, **k)

        fl.DevicePass1.run_raw_fastq = dp1_run
        fl.DeviceExact.run_raw_fastq = dxs_run
        fl.DeviceExact.run_raw_pairs = dxp_run
        return self

    def __exit__(self, *exc):
        fl = self.fl
        (fl.DevicePass1.run_raw_fastq, fl.DeviceExact.run_raw_fastq,
         fl.DeviceExact.run_raw_pairs) = self.saved


def phase_scorers():
    import pytest

    class Count:
        passed, other = 0, []

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed += 1
            elif report.failed or report.skipped:
                self.other.append(f"{report.nodeid} {report.outcome}")

    env = dict(os.environ)
    count = Count()
    t0 = time.time()
    try:
        rc = pytest.main(["-q", "-p", "no:cacheprovider", "-m", "gpu",
                          os.path.join(HERE, "tests",
                                       "test_gpu_scorers.py")],
                         plugins=[count])
    finally:
        os.environ.clear()
        os.environ.update(env)
    if rc != 0 or count.other or count.passed < 4:
        raise RuntimeError(f"gpu tests: rc={rc} passed={count.passed} "
                           f"{count.other}")
    say(f"# scorers: {count.passed} gpu tests passed in "
        f"{time.time() - t0:.2f} s [{CARD}]")


def phase_golden():
    idx = os.path.join(WORK, "golden_idx")
    cli("index", "-k", 13, "-s", 4, idx, os.path.join(DATA, "genome.fa"))
    se = os.path.join(WORK, "reads_se.fq")
    with gzip.open(os.path.join(DATA, "reads_se.fq.gz"), "rb") as f, \
            open(se, "wb") as g:
        shutil.copyfileobj(f, g)
    pe = (os.path.join(DATA, "reads_pe_1.fq"),
          os.path.join(DATA, "reads_pe_2.fq"))
    gold_se = body_lines(os.path.join(DATA, "golden_se_r1.sam.gz"))
    gold_pe = body_lines(os.path.join(DATA, "golden_pe_r1.sam"))
    runs = [("SE --device-exact", ["--device-exact"], [se], gold_se,
             "device-exact", {}),
            ("SE --device-pass1", ["--device-pass1"], [se], gold_se,
             "device-pass1", {}),
            ("SE --device-exact SMALT_DX_P2=1", ["--device-exact"], [se],
             gold_se, "device-exact", {"SMALT_DX_P2": "1"}),
            ("PE --device-exact", ["--device-exact"], list(pe), gold_pe,
             "device-exact-pe", {})]
    for name, flags, reads, gold, lane, env in runs:
        out = os.path.join(WORK, "golden.sam")
        t0 = time.time()
        with env_set(env), DeviceUse() as use:
            cli("map", "-f", "sam", "-r", 1, *flags, "-o", out, idx,
                *reads)
        dt = time.time() - t0
        got = body_lines(out)
        ndiff = sum(1 for a, b in zip(got, gold) if a != b) + \
            abs(len(got) - len(gold))
        if use.used != [lane]:
            raise RuntimeError(f"{name}: device lanes taken {use.used}")
        if env and use.p2 == 0:
            raise RuntimeError(f"{name}: device pass 2 served no "
                               f"candidate")
        if ndiff:
            raise RuntimeError(f"{name}: {ndiff} lines differ from the "
                               f"golden SAM")
        extra = f", {use.p2} pass-2 candidates on the card" if env else ""
        say(f"# golden {name}: diff empty ({len(got)} records{extra}), "
            f"{dt:.2f} s [{CARD}]")


def ecoli_corpus():
    """Genome FASTA, index prefix and read files of the E. coli-scale
    phase, all made from fixed seeds."""
    import numpy as np
    import bench
    paths = {k: os.path.join(WORK, v) for k, v in (
        ("fa", "ecoli.fa"), ("idx", "ecoli_idx"), ("se", "se.fq"),
        ("pe1", "pe_1.fq"), ("pe2", "pe_2.fq"), ("long", "long.fq"))}
    t0 = time.time()
    rng = np.random.default_rng(2024)
    genome = bench._gen_genome(rng)
    with open(paths["fa"], "w") as f:
        f.write(">ecoli_sim\n")
        for i in range(0, len(genome), 60):
            f.write(genome[i : i + 60] + "\n")
    reads, _ = bench._gen_reads(rng, genome, N_SE)
    with open(paths["se"], "w") as f:
        f.writelines(f"@r{i}\n{s}\n+\n{'5' * len(s)}\n"
                     for i, s in enumerate(reads))
    garr = np.frombuffer(genome.encode(), np.uint8)
    bench._write_pairs_chunked(garr, N_PAIRS, 150, rng, paths["pe1"],
                               paths["pe2"])
    with open(paths["long"], "w") as f:
        f.writelines(f"@L{i}\n{s}\n+\n{'5' * len(s)}\n" for i, s in
                     enumerate(bench._gen_long_reads(rng, genome, N_LONG,
                                                     LONG_LEN)))
    t1 = time.time()
    cli("index", "-k", 13, "-s", 2, paths["idx"], paths["fa"])
    say(f"# ecoli corpus: {len(genome)} bp genome and reads made in "
        f"{t1 - t0:.2f} s, index -k 13 -s 2 built in "
        f"{time.time() - t1:.2f} s (host)")
    return paths


def timed_map(name, n, args, check):
    """Run `map` twice (cold, then warm) and print one line."""
    times = []
    for _ in range(2):
        t0 = time.time()
        cli("map", *args)
        times.append(time.time() - t0)
    detail = check()
    say(f"# {name}: {n / times[1]:.1f} reads/s warm, cold "
        f"{times[0]:.2f} s, warm {times[1]:.2f} s, {n} reads{detail} "
        f"[{CARD}]")
    return times[1]


def mapped_share(path, n):
    lines = body_lines(path)
    if len(lines) != n:
        raise RuntimeError(f"{path}: {len(lines)} records, want {n}")
    mapped = sum(1 for ln in lines if not int(ln.split("\t")[1]) & 4)
    return mapped / n


def phase_ecoli(p):
    out = os.path.join(WORK, "out.sam")
    ref = os.path.join(WORK, "ref.sam")

    def fast_check(n, floor):
        def check():
            share = mapped_share(out, n)
            if share < floor:
                raise RuntimeError(f"only {share:.4f} of reads mapped")
            return f", {share:.4f} mapped"
        return check

    wall_fast = timed_map("ecoli --fast SE", N_SE,
                          ["--fast", "-o", out, p["idx"], p["se"]],
                          fast_check(N_SE, 0.95))
    timed_map("ecoli --fast PE", 2 * N_PAIRS,
              ["--fast", "-o", out, p["idx"], p["pe1"], p["pe2"]],
              fast_check(2 * N_PAIRS, 0.95))
    for name, reads, n in (("SE", [p["se"]], N_SE),
                           ("PE", [p["pe1"], p["pe2"]], 2 * N_PAIRS)):
        t0 = time.time()
        cli("map", "-f", "sam", "-r", 1, "-o", ref, p["idx"], *reads)
        t_c = time.time() - t0
        want = body_lines(ref)

        def same(want=want, n=n, t_c=t_c):
            got = body_lines(out)
            if got != want or len(got) < n:
                raise RuntimeError("device-exact output differs from the "
                                   "pure-C lane")
            return (f", byte-identical to the pure-C lane "
                    f"({n / t_c:.1f} reads/s on the host)")

        with DeviceUse() as use:
            timed_map(f"ecoli --device-exact {name}", n,
                      ["-f", "sam", "-r", 1, "--device-exact", "-o", out,
                       p["idx"], *reads], same)
        if "device-exact" not in use.used[0]:
            raise RuntimeError(f"--device-exact {name} took {use.used}")
    timed_map(f"ecoli --fast long reads {LONG_LEN} bp", N_LONG,
              ["--fast", "-o", out, p["idx"], p["long"]],
              fast_check(N_LONG, 0.9))
    device_times(p, wall_fast)


def device_times(p, wall_fast):
    """Median device time per --fast SE batch (4096 reads of 100 bp
    padded to Q=112, S=128 windows) of the plain scorer alone (3
    windows per read, tracked) and of the whole mapping step, and
    their share of the warm --fast SE wall time."""
    import jax
    import numpy as np
    from smalt_tpu.align import core as ali
    from smalt_tpu.index.table import KmerIndex
    from smalt_tpu.map.fastmode import encode_batch, iter_fastq_batches
    from smalt_tpu.ops.sw import sw_scores
    from smalt_tpu.parallel.mesh import DeviceIndex, make_device_step
    from smalt_tpu.seq.refset import RefSet

    def median_ms(f, *args):
        t0 = time.time()
        jax.block_until_ready(f(*args))
        cold = time.time() - t0
        ts = []
        for _ in range(10):
            t0 = time.time()
            jax.block_until_ready(f(*args))
            ts.append(time.time() - t0)
        return 1e3 * float(np.median(ts)), cold

    m, go, ge = ali.make_score_matrix()
    rng = np.random.default_rng(5)
    B, Q, S = 3 * FAST_BATCH, 112, 128
    q = jax.device_put(rng.integers(0, 4, (B, Q)).astype(np.int32))
    w = jax.device_put(rng.integers(0, 4, (B, S)).astype(np.int32))
    sl = jax.device_put(np.full(B, S, np.int32))
    sw_ms, sw_cold = median_ms(jax.jit(
        lambda a, b, c: sw_scores(a, b, c, m, -go, -ge, track=True)),
        q, w, sl)
    di = DeviceIndex.build(RefSet.load(p["idx"]), KmerIndex.load(p["idx"]))
    step = make_device_step(di, m, -go, -ge, pack=True)
    _, seqs, _ = next(iter_fastq_batches(p["se"], FAST_BATCH))
    reads = jax.device_put(encode_batch(seqs, Q))
    step_ms, step_cold = median_ms(step, reads)
    nbatch = -(-N_SE // FAST_BATCH)
    for name, ms, cold in (("sw_scores", sw_ms, sw_cold),
                           ("mapping step", step_ms, step_cold)):
        say(f"# {name} at --fast SE shapes (batch {FAST_BATCH}, Q={Q}, "
            f"S={S}): median {ms:.3f} ms per batch (compile {cold:.2f} "
            f"s); {nbatch} batches = "
            f"{100 * nbatch * ms / 1e3 / wall_fast:.1f}% of the warm "
            f"--fast SE wall time [{CARD}]")


def phase_four(p):
    import jax
    n = len(jax.devices())
    if n < 4:
        raise RuntimeError(f"--four needs 4 devices, found {n}")
    out = os.path.join(WORK, "mesh.sam")
    for name, reads, nreads in (("SE", [p["se"]], N_SE),
                                ("PE", [p["pe1"], p["pe2"]], 2 * N_PAIRS)):
        base = []

        def same_as_one_card():
            got = body_lines(out)
            if not base:
                base.extend(got)
                if len(got) != nreads:
                    raise RuntimeError(f"{len(got)} records")
                return ""
            if got != base:
                nd = sum(1 for a, b in zip(got, base) if a != b)
                raise RuntimeError(f"{nd} records differ from one card")
            return ", byte-identical to one card"

        for mesh in ("1,1", "4,1", "2,2", None):
            label = f"--mesh {mesh}" if mesh else f"auto dp over {n}"
            args = ["--fast", "-o", out] + (["--mesh", mesh] if mesh else [])
            timed_map(f"four --fast {name} {label}", nreads,
                      args + [p["idx"], *reads], same_as_one_card)


def main(argv=None):
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="four cards: run the mesh phase only")
    a = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, "smalt_tpu")):
        print("chip_smoke.py must run from a checkout of smalt_tpu",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    # keep the CPU backend beside the card: phase 2 compares with it
    plat = os.environ.get("JAX_PLATFORMS")
    if plat and "cpu" not in plat.split(","):
        os.environ["JAX_PLATFORMS"] = plat + ",cpu"
    import jax
    devs = jax.devices()
    d = devs[0]
    say(f"# jax.devices(): {devs}")
    if d.platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX platform {d.platform!r})",
              file=sys.stderr)
        return 1
    CARD = card_info()
    say(f"# card: {CARD}")
    from smalt_tpu.device import ensure_compile_cache
    say(f"# compile cache: {ensure_compile_cache()}")
    os.makedirs(WORK, exist_ok=True)
    failed = []

    def run(name, fn, *args):
        t0 = time.time()
        try:
            res = fn(*args)
            say(f"# phase {name}: ok in {time.time() - t0:.2f} s")
            return res
        except Exception:
            traceback.print_exc()
            say(f"# phase {name}: FAILED after {time.time() - t0:.2f} s")
            failed.append(name)
            return None

    try:
        if a.four:
            corpus = run("corpus", ecoli_corpus)
            if corpus:
                run("four", phase_four, corpus)
        else:
            run("scorers", phase_scorers)
            run("golden", phase_golden)
            corpus = run("corpus", ecoli_corpus)
            if corpus:
                run("ecoli", phase_ecoli, corpus)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
