"""Multi-host scaffolding (VERDICT r1 item 5): batch-striped shards
from N simulated hosts must merge back byte-identical to the
single-host run, through the ShardWriter/merge_shards path the CLI
uses."""
import io
import os

import numpy as np

from smalt_tpu.map.fastmode import run_fast_pipeline
from smalt_tpu.parallel.distributed import ShardWriter, merge_shards


def test_two_host_stripe_merge(tmp_path):
    from smalt_tpu.seq.refset import RefSet
    from smalt_tpu.index.table import build_index
    rng = np.random.default_rng(61)
    genome = "".join("ACGT"[i] for i in rng.integers(0, 4, 15000))
    fa = os.path.join(tmp_path, "g.fa")
    with open(fa, "w") as f:
        f.write(">g\n" + genome + "\n")
    refset = RefSet.from_fasta(fa)
    idx = build_index(refset, 11, 2)
    qlen = 70
    comp = str.maketrans("ACGT", "TGCA")
    recs = []
    for i in range(70):     # several batches of 16, not a multiple
        st = int(rng.integers(0, len(genome) - qlen))
        s = genome[st : st + qlen]
        if i % 2:
            s = s.translate(comp)[::-1]
        recs.append(f"@s{i}\n{s}\n+\n{'I' * qlen}\n")
    fq = os.path.join(tmp_path, "r.fq")
    open(fq, "w").write("".join(recs))

    single = io.StringIO()
    run_fast_pipeline(refset, idx, fq, single, nthreads=1, batch=16)

    shard_paths = []
    n_hosts = 3
    for h in range(n_hosts):
        p = os.path.join(tmp_path, f"out.sam.shard{h}")
        sw = ShardWriter(p, h, n_hosts)
        run_fast_pipeline(refset, idx, fq, None, nthreads=1, batch=16,
                          host_id=h, n_hosts=n_hosts,
                          shard_writer=sw)
        sw.close()
        shard_paths.append(p)

    merged = io.StringIO()
    nb = merge_shards(shard_paths, merged)
    assert nb == 5  # ceil(70/16)
    assert merged.getvalue() == single.getvalue()


def test_merge_shards_cli(tmp_path):
    """merge-shards CLI command over hand-built shards."""
    from smalt_tpu import cli
    paths = []
    for h in range(2):
        p = os.path.join(tmp_path, f"x.sam.shard{h}")
        sw = ShardWriter(p, h, 2)
        for b in range(h, 4, 2):
            sw.write_batch(b, f"rec batch {b}\n")
        sw.close()
        paths.append(p)
    with open(os.path.join(tmp_path, "x.sam.header"), "w") as f:
        f.write("@HD\tVN:1.4\n")
    out = os.path.join(tmp_path, "merged.sam")
    assert cli.cmd_merge_shards([out] + paths) == 0
    got = open(out).read()
    assert got == "@HD\tVN:1.4\nrec batch 0\nrec batch 1\n" \
                  "rec batch 2\nrec batch 3\n"
