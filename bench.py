"""smalt_tpu benchmark: device mapping throughput on one GPU at
E. coli scale (BASELINE.json config 2: 4.6 Mb genome, 100 bp reads,
k=13 step=2).  A run that finds no GPU fails.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "reads/s", "vs_baseline": N}

Measures the fused device mapping step (k-mer lookup + diagonal voting
+ batched Smith-Waterman, smalt_tpu/parallel/mesh.py) in steady
state.  The genome and reads are generated deterministically (seeded)
at bench time; reads carry 1% substitution errors.

Baseline: reference SMALT 0.7.6 single-threaded on one CPU core over
the identical genome/index/reads: 15812 reads/s (best of repeated
2026-08-16 measurements on this host, same k/step — the conservative
choice for the ratio).  Set $SMALT_REF to a reference binary, or have
a build at /tmp/refbuild/src/smalt, to re-measure live; the measured
value is used only if it exceeds the constant (host-load noise must
not inflate the ratio).
"""
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

BASELINE_READS_PER_S = 15812.0
GENOME_LEN = 4_600_000
READLEN = 100
KMER, NSKIP = 13, 2


def _gen_genome(rng):
    """Random genome with a planted repeat fraction (~5%): dispersed
    near-identical copies of a few units plus a tandem array — real
    genomes are not uniform-random, and the repeat structure exercises
    the MAXC truncation / mapq-cap path of the device pass."""
    bases = np.array(list(b"ACGT"), np.uint8)
    g = rng.choice(bases, GENOME_LEN)
    units = [rng.choice(bases, n) for n in (800, 1500, 3000)]
    n_copies = (60, 40, 25)
    for unit, nc in zip(units, n_copies):
        for _ in range(nc):
            cp = unit.copy()
            for j in rng.integers(0, len(cp), max(1, len(cp) // 100)):
                cp[j] = bases[int(rng.integers(0, 4))]
            at = int(rng.integers(0, GENOME_LEN - len(cp)))
            g[at : at + len(cp)] = cp
    tandem = rng.choice(bases, 500)
    at = int(rng.integers(0, GENOME_LEN - 20 * 500))
    g[at : at + 20 * 500] = np.tile(tandem, 20)
    return g.tobytes().decode()


def _gen_reads(rng, genome, n):
    comp = str.maketrans("ACGT", "TGCA")
    reads = []
    truth = np.empty(n, np.int64)
    for r in range(n):
        pos = int(rng.integers(0, len(genome) - READLEN))
        truth[r] = pos
        s = list(genome[pos : pos + READLEN])
        muts = rng.random(READLEN) < 0.01
        for i in np.flatnonzero(muts):
            s[i] = "ACGT"[(("ACGT".index(s[i]) + 1 + int(rng.random() * 3)) % 4)]
        s = "".join(s)
        if rng.random() < 0.5:
            s = s.translate(comp)[::-1]
        reads.append(s)
    return reads, truth


def measure_reference(fa_path, reads):
    """(baseline, live): `live` is the reference binary measured on the
    SAME repeat-planted genome/reads (None without a binary); `baseline`
    is the conservative max(live, recorded constant) used for the
    device-step ratio so host-load noise can never inflate it.  The
    end-to-end ratios use `live` when available — the repeat genome
    slows the reference's own exhaustive search too, and comparing our
    end-to-end numbers against the uniform-genome constant would be
    comparing different workloads."""
    ref = os.environ.get("SMALT_REF") or "/tmp/refbuild/src/smalt"
    if not os.path.exists(ref):
        return BASELINE_READS_PER_S, None
    with tempfile.TemporaryDirectory() as d:
        fq = os.path.join(d, "reads.fq")
        with open(fq, "w") as f:
            for i, s in enumerate(reads):
                f.write(f"@r{i}\n{s}\n+\n{'5' * len(s)}\n")
        subprocess.run([ref, "index", "-k", str(KMER), "-s", str(NSKIP),
                        os.path.join(d, "idx"), fa_path],
                       check=True, capture_output=True)
        best = 0.0
        for _ in range(3):
            t0 = time.time()
            subprocess.run([ref, "map", "-f", "sam", "-o", os.devnull,
                            os.path.join(d, "idx"), fq],
                           check=True, capture_output=True)
            best = max(best, len(reads) / (time.time() - t0))
        return max(best, BASELINE_READS_PER_S), best


def main():
    # latch the C lane's stage profiler ON before the first native call
    # (fl_prof_on is read once per process): the exact-lane stage split
    # goes into the bench artifact as the chip-vs-host-bound record
    os.environ.setdefault("SMALT_FL_TIMING", "1")
    import jax
    import jax.numpy as jnp
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: no GPU found (JAX platform {dev.platform!r})",
              file=sys.stderr)
        sys.exit(1)

    from smalt_tpu.seq import codec
    from smalt_tpu.seq.refset import RefSet
    from smalt_tpu.index.table import build_index
    from smalt_tpu.align import core as ali
    from smalt_tpu.parallel.mesh import DeviceIndex, device_map_step

    rng = np.random.default_rng(123)
    genome = _gen_genome(rng)
    with tempfile.NamedTemporaryFile("w", suffix=".fa", delete=False) as f:
        f.write(">ecoli_sim\n")
        for i in range(0, len(genome), 60):
            f.write(genome[i : i + 60] + "\n")
        fa_path = f.name
    refset = RefSet.from_fasta(fa_path)
    idx = build_index(refset, KMER, NSKIP)
    di = DeviceIndex.build(refset, idx)
    jax.block_until_ready(di.ref_alpha)
    m, go, ge = ali.make_score_matrix()

    BATCH = 32768
    INNER = 10
    reads, truth = _gen_reads(rng, genome, BATCH)
    arr = np.full((BATCH, READLEN), 7, np.int32)
    for i, s in enumerate(reads):
        arr[i] = codec.alpha(codec.encode(s.encode()))
    batch = jnp.asarray(arr)

    # INNER steps run inside one dispatch (fori_loop) so per-dispatch
    # overhead divides out — the steady state a streaming input
    # pipeline sustains.  Index arrays pass
    # as jit arguments (pytree), not closure constants: the k13 direct
    # lookup table is 512 MB (4^13 int32 pairs) and must stay a runtime
    # parameter.
    arrs = {"words": di.words, "starts": di.starts, "pos": di.pos,
            "ref": di.ref_alpha}
    if di.table is not None:
        arrs["table"] = di.table
    meta = (di.wordlen, di.nskip, di.ref_len)

    def _di(a):
        return DeviceIndex(wordlen=meta[0], nskip=meta[1], words=a["words"],
                           starts=a["starts"], pos=a["pos"],
                           ref_alpha=a["ref"], ref_len=meta[2],
                           table=a.get("table"))

    def many(b, a):
        d = _di(a)
        def body(i, acc):
            out = device_map_step(d, b + (i - i), m, -go, -ge)
            return acc + jnp.sum(out["score"])
        return jax.lax.fori_loop(0, INNER, body, jnp.int32(0))

    f = jax.jit(many)
    int(f(batch, arrs))  # compile + warm
    outer = 3
    t0 = time.time()
    for _ in range(outer):
        int(f(batch, arrs))
    dt = (time.time() - t0) / (outer * INNER)
    reads_per_s = BATCH / dt

    step = jax.jit(lambda b, a: device_map_step(_di(a), b, m, -go, -ge))
    out = step(batch, arrs)
    sc = np.asarray(out["score"])
    mapped_frac = float((sc >= 50).mean())
    # positional truth, not just score: the placement window must cover
    # the true origin — except score-ties, where another repeat copy is
    # an equally correct placement
    st = np.asarray(out["start"]).astype(np.int64)
    tie = np.asarray(out["score2"]) >= sc
    near = np.abs(st - truth) <= 2 * READLEN
    on_target_frac = float((near | tie)[sc >= 50].mean())

    # time the reference on a 2000-read file
    ref_reads = reads[:2000]
    baseline, live_ref = measure_reference(fa_path, ref_reads)

    # --- end-to-end map --fast: FASTQ on disk -> SAM on disk, one
    # process, C batched tail + single packed fetch per batch ---
    e2e_rate = e2e_rate_n2 = exact_rate = dp1_rate = dx_rate = 0.0
    fidelity = None
    pe_rate = pe_ref = 0.0
    long_rate = long_bases = long_ref = 0.0
    chr_rate = 0.0
    exact_split = fast_split = None
    try:
        (e2e_rate, e2e_rate_n2, exact_rate, dp1_rate, dx_rate,
         exact_split, fast_split, fidelity) = \
            _bench_end_to_end(fa_path, genome, rng)
        pe_rate, pe_ref = _bench_exact_pe(fa_path, genome, rng)
        pe_dx, pe_adj, _ = _bench_exact_pe_devx(fa_path, genome, rng)
        globals()["_pe_dx"] = (round(pe_dx, 1), round(pe_adj, 1),
                               round(pe_dx / pe_adj, 3)
                               if pe_adj else 0.0)
        long_rate, long_bases, long_ref = \
            _bench_longreads(fa_path, genome, rng)
    except Exception as e:        # noqa: BLE001 - report, don't fail bench
        print(f"# end_to_end bench failed: {e!r}", file=sys.stderr)
    os.unlink(fa_path)
    config4 = {}
    try:
        config4 = _bench_chr_scale()
        chr_rate = config4.get("config4_reads_per_s", 0.0)
    except Exception as e:        # noqa: BLE001
        print(f"# chr_scale bench failed: {e!r}", file=sys.stderr)
    e2e_base = live_ref if live_ref else baseline
    result = {
        "metric": "ecoli_scale_device_map_throughput",
        "value": round(reads_per_s, 1),
        "unit": "reads/s",
        "vs_baseline": round(reads_per_s / baseline, 3),
        "end_to_end_fast_reads_per_s": round(e2e_rate, 1),
        "end_to_end_fast_vs_ref_same_genome": round(e2e_rate / e2e_base, 3),
        "end_to_end_fast_nthreads2_reads_per_s": round(e2e_rate_n2, 1),
        "exact_lane_reads_per_s": round(exact_rate, 1),
        "exact_lane_vs_ref_same_genome": round(exact_rate / e2e_base, 3),
        "exact_dp1_reads_per_s": round(dp1_rate, 1),
        "exact_devx_reads_per_s": round(dx_rate, 1),
        "exact_adjacent_reads_per_s": globals().get("_dx_vs_adj",
                                                    (0.0, 0.0))[0],
        "exact_devx_vs_adjacent_exact": globals().get("_dx_vs_adj",
                                                      (0.0, 0.0))[1],
        "reference_same_genome_reads_per_s": round(live_ref or 0.0, 1),
        "exact_pe_reads_per_s": round(pe_rate, 1),
        "exact_pe_vs_ref": round(pe_rate / pe_ref, 3) if pe_ref else 0.0,
        "exact_pe_devx_reads_per_s": globals().get("_pe_dx",
                                                   (0.0,) * 3)[0],
        "exact_pe_adjacent_reads_per_s": globals().get("_pe_dx",
                                                       (0.0,) * 3)[1],
        "exact_pe_devx_vs_adjacent": globals().get("_pe_dx",
                                                   (0.0,) * 3)[2],
        "chr_scale_fast_pe_reads_per_s": round(chr_rate, 1),
        "longread_fast_reads_per_s": round(long_rate, 1),
        "longread_fast_bases_per_s": round(long_bases, 1),
        "longread_vs_ref": round(long_rate / long_ref, 3) if long_ref
        else 0.0,
    }
    result.update(config4)
    if fidelity:
        result["fast_fidelity"] = fidelity
    if fast_split:
        # Where a fast-mode read's 1/rate goes: host stages
        # (parse+encode+tail) vs the serialized device dispatch+fetch;
        # host_only_ceiling is the rate with the transfer fully hidden
        # by the prefetch overlap.
        result["fast_stage_split"] = fast_split
    if exact_split:
        # Where the byte-identical lane's time goes on ONE host core
        # (percent of in-C time): seeding, exact pass-2 and render are
        # host stages.
        result["exact_stage_split_pct"] = exact_split
        host_share = (100.0 - exact_split["pass1_sw"]) / 100.0
        if exact_rate and host_share > 0:
            percore_dp1_ceiling = exact_rate / host_share
            result["projected_exact_dp1_8core_reads_per_s"] = round(
                8 * percore_dp1_ceiling, 1)
            result["projection_note"] = (
                "projected = 8 host cores x (exact lane with the chip "
                "absorbing the pass-1 SW share); pool scaling proven "
                "deterministic, linearity assumed (reference scales the "
                "same way via threads.c)")
    result["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                        "count": len(jax.devices())}
    result["host_cpus"] = os.cpu_count()
    print(json.dumps(result))
    print(f"# backend={jax.default_backend()} batch={BATCH} "
          f"steady={dt*1000:.2f}ms mapped_frac={mapped_frac:.3f} "
          f"on_target_frac={on_target_frac:.3f} "
          f"baseline={baseline:.0f} reads/s (reference smalt, 1 CPU core, "
          f"same genome/reads/k/step)", file=sys.stderr)


def _fast_stage_split(refset, idx, fq, batch):
    """Per-stage host/device split of the FAST pipeline, measured on
    the warm state the main timed run leaves behind (cached device
    index upload + compiled step on `idx`).  Stages: parse (C FASTQ
    scan), encode (C 3-bit packer), device step + packed fetch run
    SERIALLY (the un-overlapped upper bound of the dispatch/transfer
    cost — the pipeline itself hides most of it behind PREFETCH and
    copy_to_host_async), tail (C render).  parse+encode+tail is the
    pipeline's host-only ceiling: what one host core sustains when the
    transfer vanishes into overlap."""
    import time
    import jax.numpy as jnp
    from smalt_tpu.map import fastmode as fm
    from smalt_tpu.parallel.mesh import OUT_KEYS, window_len, window_pad

    t0 = time.time()
    batches = list(fm.iter_fastq_hybrid(fq, batch))
    t_parse = time.time() - t0
    if not all(isinstance(b, fm.RawBatch) for b in batches):
        return None
    n = sum(b.n for b in batches)
    step = getattr(idx, "_fast_step_cache", {}).get(
        (1, 1, (1, -2, -4, -3)))
    if not n or step is None:
        return None
    Qs = [max(32, -(-int(b.seq_len.max()) // 16) * 16) for b in batches]
    t0 = time.time()
    encs = [b.encode(Q) for b, Q in zip(batches, Qs)]
    t_enc = time.time() - t0
    t_dev = 0.0
    outs_all = []
    for b, enc in zip(batches, encs):
        arr = enc
        if arr.shape[0] != batch:   # same one-shape rule as the pipeline
            arr = np.pad(arr, ((0, batch - arr.shape[0]), (0, 0)),
                         constant_values=7)
        t0 = time.time()
        o = np.asarray(step(jnp.asarray(arr)))
        t_dev += time.time() - t0
        outs_all.append({k: o[i, : b.n] for i, k in enumerate(OUT_KEYS)})
    fm._tail_init(refset, (1, -2, -4, -3), 18, (True, False), (0, 500),
                  None, 1, None, None)
    args = []
    base = 0
    for b, outs, Q in zip(batches, outs_all, Qs):
        args.append((False, b, outs, window_len(Q), window_pad(Q), Q,
                     base))
        base += b.n
    for a in args:                 # warm lane scratch buffers
        fm._tail_render(a)
    t0 = time.time()
    for a in args:                 # deterministic: per-read RNG reseeds
        fm._tail_render(a)
    t_tail = time.time() - t0
    host = t_parse + t_enc + t_tail

    def us(t):
        return round(t / n * 1e6, 2)

    return {"parse_us_per_read": us(t_parse),
            "encode_us_per_read": us(t_enc),
            "device_step_fetch_serial_us_per_read": us(t_dev),
            "tail_us_per_read": us(t_tail),
            "host_only_ceiling_reads_per_s": round(n / host, 1)}


def _bench_end_to_end(fa_path, genome, rng):
    """(fast_e2e, fast_e2e_nthreads2, exact_lane, exact_dp1) reads/s:
    full CLI-path pipelines, FASTQ to SAM text, one host core + (for
    fast/dp1) one chip.  Measured warm (index artifacts cached, jit
    compiled by a small priming run) — the steady state of a
    production run."""
    import io
    import time
    from smalt_tpu.seq.refset import RefSet
    from smalt_tpu.index.table import build_index, KmerIndex
    from smalt_tpu.map.fastmode import run_fast_pipeline
    from smalt_tpu.map.engine import MapEngine, MapParams
    from smalt_tpu.map.pipeline import run_pipeline_raw_fastq

    N_FAST = 100_000
    N_EXACT = 20_000
    refset = RefSet.from_fasta(fa_path)
    idx = build_index(refset, KMER, NSKIP)
    reads, _ = _gen_reads(rng, genome, max(N_FAST, N_EXACT))
    fq = fa_path + ".bench.fq"
    with open(fq, "w") as f:
        for i, s in enumerate(reads[:N_FAST]):
            f.write(f"@e{i}\n{s}\n+\n{'5' * len(s)}\n")
    fq_small = fa_path + ".warm.fq"
    with open(fq_small, "w") as f:
        # warm run uses the SAME batch size as the main run: a second
        # (B, Q) shape would trigger another compile mid-bench
        for i, s in enumerate(reads[:8192]):
            f.write(f"@w{i}\n{s}\n+\n{'5' * len(s)}\n")

    kw = dict(nthreads=1, batch=8192)
    run_fast_pipeline(refset, idx, fq_small, io.StringIO(), **kw)  # warm
    sink = io.StringIO()
    t0 = time.time()
    run_fast_pipeline(refset, idx, fq, sink, **kw)
    e2e = N_FAST / (time.time() - t0)
    nrec = sum(1 for l in sink.getvalue().splitlines()
               if l and not l.startswith("@"))
    assert nrec == N_FAST, nrec

    # stage split on the warm state
    fast_split = None
    try:
        fast_split = _fast_stage_split(refset, idx, fq, 8192)
    except Exception as e:   # noqa: BLE001 - diagnostic, not vital
        print(f"# fast stage split failed: {e!r}", file=sys.stderr)

    # nthreads sweep point (VERDICT r2 #2): the forked tail pool
    kw2 = dict(kw)
    kw2["nthreads"] = 2
    t0 = time.time()
    run_fast_pipeline(refset, idx, fq, io.StringIO(), **kw2)
    e2e_n2 = N_FAST / (time.time() - t0)

    fqx = fa_path + ".exact.fq"
    with open(fqx, "w") as f:
        for i, s in enumerate(reads[:N_EXACT]):
            f.write(f"@x{i}\n{s}\n+\n{'5' * len(s)}\n")
    from smalt_tpu import rand
    from smalt_tpu.native import get_lib
    import ctypes
    import numpy as _np

    def _stage_split(reset_only=False):
        """The C lane's per-stage split (SMALT_FL_TIMING buckets).
        run_pipeline_raw_fastq's own reporter fetch-resets the buckets,
        so read its cached last report; fall back to a direct fetch."""
        import smalt_tpu.native as native
        lib = get_lib()
        acc = _np.zeros(16)   # FL_PROF_N doubles (fastlane.c)
        if lib is not None and hasattr(lib, "fl_prof_fetch"):
            lib.fl_prof_fetch(acc.ctypes.data_as(ctypes.c_void_p), 1)
        if reset_only:
            native.fl_prof_lastreport = {}
            return None
        rep = native.fl_prof_lastreport
        vals = ([rep.get(k, 0.0) for k in native.FL_PROF_STAGES[:4]]
                if rep else list(acc[:4]))
        tot = sum(vals)
        if tot <= 0:
            return None
        keys = ("seed_collate", "pass1_sw", "pass2_align", "report_render")
        return {k: round(100 * v / tot, 1) for k, v in zip(keys, vals)}

    _stage_split(reset_only=True)
    # build the direct-address host table outside the timed region: a
    # production run memory-maps it from the .smh.npy sidecar written
    # by `smalt_tpu index`, so the steady state never pays the 4^k
    # cumsum (the bench index was built in-process, skipping save/load)
    _ = idx.addrs
    rand.ranseed(1)
    eng = MapEngine(refset, idx, MapParams())
    sink2 = io.StringIO()
    t0 = time.time()
    ok = run_pipeline_raw_fastq(eng, fqx, sink2, refset)
    exact = N_EXACT / (time.time() - t0) if ok else 0.0
    split = _stage_split()

    # --device-pass1: the byte-identical device-assisted exact engine
    # (the device scores pass-1 windows, host does seeding + exact
    # pass-2).  Warm once for the jit, then measure; output equality
    # with the host lane is asserted.
    dp1 = 0.0
    os.environ.setdefault("SMALT_DP1_BATCH", "8192")
    rand.ranseed(1)
    eng_w = MapEngine(refset, idx, MapParams())
    run_pipeline_raw_fastq(eng_w, fq_small, io.StringIO(), refset,
                           device_pass1=True)
    rand.ranseed(1)
    eng2 = MapEngine(refset, idx, MapParams())
    sink3 = io.StringIO()
    t0 = time.time()
    ok2 = run_pipeline_raw_fastq(eng2, fqx, sink3, refset,
                                 device_pass1=True)
    if ok2:
        dp1 = N_EXACT / (time.time() - t0)
        assert sink3.getvalue() == sink2.getvalue(), \
            "--device-pass1 output diverged from the host lane"

    # --device-exact: the chip carries the exact front half (seeding,
    # hit collection, collation, pass-1 scoring) in one dispatch per
    # block; host keeps rank selection, depth sort, pass-2, render.
    # Byte-identity with the host lane is asserted.
    # batch 8192: the device leg's fixed costs (dispatch, D2H
    # latency) need the larger block to amortize, and the 2-deep
    # pipeline's drain needs >= ~6 batches to wash out — measure
    # over its own longer corpus with an ADJACENT pure-C run for
    # the drift-free ratio
    dx = 0.0
    os.environ.setdefault("SMALT_DX_BATCH", "8192")
    N_DX = 49152
    fqdx = fa_path + ".dx.fq"
    with open(fqdx, "w") as f:
        for i, s in enumerate(reads[:N_DX]):
            f.write(f"@x{i}\n{s}\n+\n{'5' * len(s)}\n")
    rand.ranseed(1)
    eng_w2 = MapEngine(refset, idx, MapParams())
    run_pipeline_raw_fastq(eng_w2, fq_small, io.StringIO(), refset,
                           device_exact=True)
    rand.ranseed(1)
    eng3 = MapEngine(refset, idx, MapParams())
    sink4 = io.StringIO()
    t0 = time.time()
    ok3 = run_pipeline_raw_fastq(eng3, fqdx, sink4, refset,
                                 device_exact=True)
    if ok3:
        dx = N_DX / (time.time() - t0)
    rand.ranseed(1)
    eng4 = MapEngine(refset, idx, MapParams())
    sink5 = io.StringIO()
    t0 = time.time()
    run_pipeline_raw_fastq(eng4, fqdx, sink5, refset)
    exact_adj = N_DX / (time.time() - t0)
    if ok3:
        assert sink4.getvalue() == sink5.getvalue(), \
            "--device-exact output diverged from the host lane"
    globals()["_dx_vs_adj"] = (round(exact_adj, 1),
                               round(dx / exact_adj, 3)
                               if exact_adj else 0.0)
    os.unlink(fqdx)

    # fast-mode fidelity contract vs the exact engine (VERDICT r3 #3):
    # the fast and exact runs above mapped the same first N_EXACT reads
    # (same sequence stream, names e{i}/x{i}); compare primary records.
    fidelity = None
    try:
        fast_rec, exact_rec = {}, {}
        for text, rec, pfx in ((sink.getvalue(), fast_rec, "e"),
                               (sink2.getvalue(), exact_rec, "x")):
            for ln in text.splitlines():
                if not ln or ln.startswith("@"):
                    continue
                f = ln.split("\t")
                if int(f[1]) & 0x100:
                    continue
                i = int(f[0][1:])
                if i < min(N_FAST, N_EXACT):
                    rec[i] = (int(f[1]) & 16, f[2], int(f[3]),
                              int(f[4]), f[5])
        def _tier(q):
            return 0 if q <= 3 else (1 if q < 30 else 2)
        plc = mq = mq3 = mqt = cg = 0
        for i, e in exact_rec.items():
            f = fast_rec.get(i)
            if f and f[0] == e[0] and f[1] == e[1] and \
                    abs(f[2] - e[2]) <= 2:
                plc += 1
                mq += f[3] == e[3]
                mq3 += abs(f[3] - e[3]) <= 3
                mqt += _tier(f[3]) == _tier(e[3])
                cg += f[2] == e[2] and f[4] == e[4]
        n = max(len(exact_rec), 1)
        fidelity = {
            "fast_placement_concordance": round(plc / n, 4),
            "fast_mapq_concordance": round(mq / max(plc, 1), 4),
            "fast_mapq_within3": round(mq3 / max(plc, 1), 4),
            "fast_mapq_tier_concordance": round(mqt / max(plc, 1), 4),
            "fast_cigar_concordance": round(cg / max(plc, 1), 4),
            "note": ("rates over exact primaries (n=%d); mapq diffs are"
                     " the search-completeness cap -10*log10(min(used/"
                     "(tot+3), ali/(ali_tot+3))) computed from exact-"
                     "engine counters fast seeding does not produce "
                     "(results.c:1193-1197); CIGARs compared at equal "
                     "pos; bit-identical route = --device-exact"
                     % n),
        }
    except Exception as e:     # noqa: BLE001 - diagnostic
        print(f"# fidelity compare failed: {e!r}", file=sys.stderr)
    for p in (fq, fq_small, fqx):
        os.unlink(p)
    return e2e, e2e_n2, exact, dp1, dx, split, fast_split, fidelity


def _bench_exact_pe(fa_path, genome, rng):
    """(ours, reference) paired-end exact reads/s on identical inputs:
    2x150 bp, insert ~N(400,40), 1% errors, mapping only (index
    prebuilt for ours; the reference pays its own .smi load, as its
    single-end baseline run does too)."""
    import io
    import time
    from smalt_tpu.seq.refset import RefSet
    from smalt_tpu.index.table import build_index
    from smalt_tpu.map.engine import MapEngine, MapParams
    from smalt_tpu.map.pipeline import (run_pipeline,
                                        run_pipeline_raw_pairs)
    from smalt_tpu.seq.io import PairedReader
    from smalt_tpu import rand

    comp = str.maketrans("ACGT", "TGCA")
    N, RL = 2000, 150
    fq1, fq2 = fa_path + ".pe1.fq", fa_path + ".pe2.fq"
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
    refset = RefSet.from_fasta(fa_path)
    idx = build_index(refset, KMER, NSKIP)
    _ = idx.addrs
    ours = ref_rate = 0.0
    ref = os.environ.get("SMALT_REF") or "/tmp/refbuild/src/smalt"
    with tempfile.TemporaryDirectory() as d:
        have_ref = os.path.exists(ref)
        if have_ref:
            subprocess.run([ref, "index", "-k", str(KMER), "-s",
                            str(NSKIP), os.path.join(d, "idx"), fa_path],
                           check=True, capture_output=True)
        # trials INTERLEAVED so host-frequency drift hits both engines
        # alike (best-of-3 each)
        for _r in range(3):
            rand.ranseed(1)
            eng = MapEngine(refset, idx, MapParams())
            sink = io.StringIO()
            t0 = time.time()
            # the production serial-PE route (CLI): raw-bytes C lane
            if not run_pipeline_raw_pairs(eng, fq1, fq2, sink, refset):
                run_pipeline(eng, PairedReader(fq1, fq2), sink, refset)
            ours = max(ours, 2 * N / (time.time() - t0))
            if have_ref:
                t0 = time.time()
                subprocess.run([ref, "map", "-f", "sam", "-o",
                                os.devnull, os.path.join(d, "idx"),
                                fq1, fq2],
                               check=True, capture_output=True)
                ref_rate = max(ref_rate, 2 * N / (time.time() - t0))
    os.unlink(fq1)
    os.unlink(fq2)
    return ours, ref_rate


def _bench_exact_pe_devx(fa_path, genome, rng):
    """Paired-end --device-exact vs the adjacent host pair lane on its
    own corpus (back-to-back adjacent runs for a drift-free ratio;
    byte-identity asserted)."""
    import io
    import time
    from smalt_tpu.seq.refset import RefSet
    from smalt_tpu.index.table import build_index
    from smalt_tpu.map.engine import MapEngine, MapParams
    from smalt_tpu.map.pipeline import run_pipeline_raw_pairs
    from smalt_tpu import rand

    comp = str.maketrans("ACGT", "TGCA")
    NP, RL = 12288, 150
    fq1, fq2 = fa_path + ".dxpe1.fq", fa_path + ".dxpe2.fq"
    with open(fq1, "w") as f1, open(fq2, "w") as f2:
        for i in range(NP):
            ins = int(rng.normal(400, 40))
            ins = max(2 * RL + 10, min(600, ins))
            st = int(rng.integers(0, len(genome) - ins))
            frag = genome[st : st + ins]
            a = list(frag[:RL])
            b = list(frag[-RL:])
            for arr in (a, b):
                for j in np.flatnonzero(rng.random(RL) < 0.01):
                    arr[j] = "ACGT"[int(rng.integers(0, 4))]
            f1.write(f"@q{i}\n{''.join(a)}\n+\n{'5' * RL}\n")
            f2.write(f"@q{i}\n{''.join(b).translate(comp)[::-1]}\n+\n"
                     f"{'5' * RL}\n")
    refset = RefSet.from_fasta(fa_path)
    idx = build_index(refset, KMER, NSKIP)
    _ = idx.addrs

    def leg(dx):
        rand.ranseed(1)
        eng = MapEngine(refset, idx, MapParams())
        sink = io.StringIO()
        t0 = time.time()
        ok = run_pipeline_raw_pairs(eng, fq1, fq2, sink, refset,
                                    device_exact=dx)
        return (2 * NP / (time.time() - t0) if ok else 0.0,
                sink.getvalue())

    leg(True)                              # warm: compile + residency
    dx_rate, dx_text = leg(True)
    host_rate, host_text = leg(False)
    identical = dx_text == host_text
    assert identical, \
        "PE --device-exact output diverged from the host pair lane"
    os.unlink(fq1)
    os.unlink(fq2)
    return dx_rate, host_rate, identical


def _gen_long_reads(rng, genome, n, RL):
    """n noisy kilobase reads of length RL (454/PacBio-style: 1%
    substitutions + 1.5% indels), half reverse-complemented."""
    comp = str.maketrans("ACGT", "TGCA")
    reads = []
    for _ in range(n):
        pos = int(rng.integers(0, len(genome) - RL - 100))
        src = genome[pos : pos + RL + 100]
        out = []
        j = 0
        while j < len(src) and len(out) < RL:
            r = rng.random()
            if r < 0.0075:              # deletion
                j += 1
                continue
            if r < 0.015:               # insertion
                out.append("ACGT"[int(rng.integers(0, 4))])
                continue
            c = src[j]
            if r < 0.025:               # substitution
                c = "ACGT"[(("ACGT".index(c) + 1 +
                             int(rng.random() * 3)) % 4)]
            out.append(c)
            j += 1
        s = "".join(out[:RL])
        if rng.random() < 0.5:
            s = s.translate(comp)[::-1]
        reads.append(s)
    return reads


def _bench_longreads(fa_path, genome, rng):
    """BASELINE config 5: kilobase noisy reads through the fast pipeline
    — the banded device scorer (Q > LONG_READ_Q) plus the banded host
    tail.  Returns (reads_per_s, bases_per_s, ref_reads_per_s) — the
    last is the live reference binary on the SAME reads/genome (0.0
    without a binary; its 16-bit wide-band kernel slot,
    swsimd.c:443)."""
    import io
    import time
    from smalt_tpu.seq.refset import RefSet
    from smalt_tpu.index.table import build_index
    from smalt_tpu.map.fastmode import run_fast_pipeline

    N = 2048
    RL = 1500
    fq = fa_path + ".long.fq"
    with open(fq, "w") as f:
        for i, s in enumerate(_gen_long_reads(rng, genome, N, RL)):
            f.write(f"@L{i}\n{s}\n+\n{'5' * len(s)}\n")
    refset = RefSet.from_fasta(fa_path)
    idx = build_index(refset, KMER, NSKIP)
    # batch 128: not yet swept on the GPU
    kw = dict(nthreads=1, batch=128)
    run_fast_pipeline(refset, idx, fq, io.StringIO(), **kw)  # warm/compile
    sink = io.StringIO()
    t0 = time.time()
    run_fast_pipeline(refset, idx, fq, sink, **kw)
    dt = time.time() - t0
    nrec = sum(1 for l in sink.getvalue().splitlines()
               if l and not l.startswith("@"))
    assert nrec == N, nrec
    # live reference on the same long reads (subset keeps bench time
    # bounded; rate is per-read so the subset is representative)
    ref_rate = 0.0
    ref = os.environ.get("SMALT_REF") or "/tmp/refbuild/src/smalt"
    if os.path.exists(ref):
        import subprocess
        import tempfile
        nsub = min(N, 256)
        with tempfile.TemporaryDirectory() as d:
            sub = os.path.join(d, "sub.fq")
            with open(sub, "w") as f, open(fq) as src:
                for _ in range(4 * nsub):
                    f.write(src.readline())
            subprocess.run([ref, "index", "-k", str(KMER), "-s",
                            str(NSKIP), os.path.join(d, "idx"), fa_path],
                           check=True, capture_output=True)
            for _ in range(2):
                t0 = time.time()
                subprocess.run([ref, "map", "-f", "sam", "-o", os.devnull,
                                os.path.join(d, "idx"), sub],
                               check=True, capture_output=True)
                ref_rate = max(ref_rate, nsub / (time.time() - t0))
    os.unlink(fq)
    return N / dt, N * RL / dt, ref_rate


def _gen_chr_surrogate(GLEN, rng):
    """chr20-scale repeat-structured surrogate (BASELINE config 4).
    Real chr20 is unobtainable offline (zero egress), so the genome
    is random sequence with a repeat structure matched to the human
    genome's broad classes — the repeat mass is what stresses seed
    budgets/repeat cutoffs/mapq at scale, not the exact sequence:
    ~10% SINE-like (300 bp unit, ~2% divergence, dispersed), ~10%
    LINE-like (3 kb unit, ~5% divergence), plus three ~100 kb
    alpha-satellite-like tandem arrays (171 bp unit)."""
    bases = np.array(list(b"ACGT"), np.uint8)
    g = rng.choice(bases, GLEN)

    def plant(unit_len, n_copies, div):
        unit = rng.choice(bases, unit_len)
        ats = rng.integers(0, GLEN - unit_len, n_copies)
        for at in ats:
            cp = unit.copy()
            nmut = max(1, int(unit_len * div))
            ix = rng.integers(0, unit_len, nmut)
            cp[ix] = bases[rng.integers(0, 4, nmut)]
            g[at:at + unit_len] = cp

    plant(300, GLEN // 3000, 0.02)       # ~10% SINE-like
    plant(3000, GLEN // 30000, 0.05)     # ~10% LINE-like
    for _ in range(3):
        unit = rng.choice(bases, 171)
        reps = 100_000 // 171
        at = int(rng.integers(0, GLEN - reps * 171))
        g[at:at + reps * 171] = np.tile(unit, reps)
    return g


_RC_LUT = np.zeros(256, np.uint8)
for _a, _b in zip(b"ACGT", b"TGCA"):
    _RC_LUT[_a] = _b


def _write_pairs_chunked(genome_arr, NPAIR, RL, rng, fq1, fq2,
                         chunk=50_000):
    """Vectorized paired-read generator (10M-pair scale): gathers,
    mutates and revcomps whole chunks with numpy; only the FASTQ text
    assembly is per-record."""
    GLEN = len(genome_arr)
    bases = np.array(list(b"ACGT"), np.uint8)
    qual = "5" * RL
    done = 0
    with open(fq1, "w") as f1, open(fq2, "w") as f2:
        while done < NPAIR:
            n = min(chunk, NPAIR - done)
            ins = np.clip(rng.normal(400, 40, n).astype(np.int64),
                          2 * RL + 10, 600)
            st = rng.integers(0, GLEN - 600, n)
            offs = np.arange(RL)
            A = genome_arr[st[:, None] + offs[None, :]].copy()
            B = genome_arr[(st + ins - RL)[:, None] + offs[None, :]]
            B = _RC_LUT[B[:, ::-1]].copy()
            for arr in (A, B):
                m = rng.random((n, RL)) < 0.01
                arr[m] = bases[rng.integers(0, 4, int(m.sum()))]
            b1, b2 = [], []
            for j in range(n):
                nm = done + j
                b1.append(f"@c{nm}\n{A[j].tobytes().decode()}\n+\n"
                          f"{qual}")
                b2.append(f"@c{nm}\n{B[j].tobytes().decode()}\n+\n"
                          f"{qual}")
            f1.write("\n".join(b1) + "\n")
            f2.write("\n".join(b2) + "\n")
            done += n


def _bench_chr_scale():
    """BASELINE config 4 (scaled): chromosome-size genome (64 Mb, human
    chr20-like scale) mapped paired-end through the fast CLI path on
    one GPU.  The mesh paths run on four cards in
    `chip_smoke.py --four`."""
    import io
    import tempfile
    import time
    from smalt_tpu.seq.refset import RefSet
    from smalt_tpu.index.table import build_index
    from smalt_tpu.map.fastmode import run_fast_pipeline

    GLEN = 64_000_000
    # BASELINE config 4 spec: >= 60 Mb reference, >= 1M pairs
    # (VERDICT r3 #6); SMALT_CONFIG4_PAIRS overrides
    NPAIR = int(os.environ.get("SMALT_CONFIG4_PAIRS", 1_000_000))
    RL = 150
    rng = np.random.default_rng(77)
    # round 5: chr20-like REPEAT-STRUCTURED surrogate (the r4 uniform
    # genome understated repeat stress; VERDICT r4 #6)
    g = _gen_chr_surrogate(GLEN, rng)
    genome = g.tobytes().decode()
    with tempfile.TemporaryDirectory() as d:
        fa = os.path.join(d, "chr.fa")
        with open(fa, "w") as f:
            f.write(">chr20_sim\n")
            for i in range(0, GLEN, 10000):
                f.write(genome[i : i + 10000] + "\n")
        fq1 = os.path.join(d, "r1.fq")
        fq2 = os.path.join(d, "r2.fq")
        _write_pairs_chunked(g, NPAIR, RL, rng, fq1, fq2)
        refset = RefSet.from_fasta(fa)
        idx = build_index(refset, KMER, NSKIP)
        kw = dict(nthreads=1, batch=8192)
        # warm: compile + device index upload
        wfq1 = os.path.join(d, "w1.fq")
        wfq2 = os.path.join(d, "w2.fq")
        with open(fq1) as src, open(wfq1, "w") as dst:
            for _ in range(4 * 8192):
                dst.write(src.readline())
        with open(fq2) as src, open(wfq2, "w") as dst:
            for _ in range(4 * 8192):
                dst.write(src.readline())
        run_fast_pipeline(refset, idx, wfq1, io.StringIO(),
                          mates_path=wfq2, **kw)
        sink = io.StringIO()
        t0 = time.time()
        run_fast_pipeline(refset, idx, fq1, sink, mates_path=fq2, **kw)
        dt = time.time() - t0
        nrec = sum(1 for l in sink.getvalue().splitlines()
                   if l and not l.startswith("@"))
        assert nrec == 2 * NPAIR, nrec
        res = {"config4_genome_mb": GLEN // 1_000_000,
               "config4_pairs": NPAIR,
               "config4_reads_per_s": round(2 * NPAIR / dt, 1)}
        return res


if __name__ == "__main__":
    main()
