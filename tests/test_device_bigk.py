"""Device index for k = 16..20 (VERDICT r1 item 8): the split-word
(hi, lo) lookup must place reads exactly like the host engine across
the reference's full word-length range (menu.c:595)."""
import io
import os

import numpy as np
import pytest

from smalt_tpu.seq.refset import RefSet
from smalt_tpu.index.table import build_index


@pytest.fixture(scope="module")
def genome_world(tmp_path_factory):
    rng = np.random.default_rng(67)
    bases = np.array(list(b"ACGT"), np.uint8)
    g = rng.choice(bases, 30000).tobytes().decode()
    d = tmp_path_factory.mktemp("bigk")
    fa = os.path.join(d, "g.fa")
    with open(fa, "w") as f:
        f.write(">g\n" + g + "\n")
    return RefSet.from_fasta(fa), g


@pytest.mark.parametrize("k,nskip", [(16, 2), (18, 3), (20, 2)])
def test_device_placement_bigk(genome_world, k, nskip):
    import jax.numpy as jnp
    from smalt_tpu.align import core as ali
    from smalt_tpu.parallel.mesh import DeviceIndex, device_map_step
    from smalt_tpu.seq import codec
    refset, g = genome_world
    idx = build_index(refset, k, nskip)
    di = DeviceIndex.build(refset, idx)
    assert di.words_lo is not None and di.hi_table is not None
    m, go, ge = ali.make_score_matrix()
    rng = np.random.default_rng(k)
    qlen = 96
    B = 32
    arr = np.full((B, qlen), 7, np.int32)
    truth = []
    comp = str.maketrans("ACGT", "TGCA")
    for i in range(B):
        st = int(rng.integers(0, len(g) - qlen))
        s = g[st : st + qlen]
        if i % 2:
            s = s.translate(comp)[::-1]
        arr[i] = codec.alpha(codec.encode(s.encode()))
        truth.append((st, i % 2 == 1))
    out = device_map_step(di, jnp.asarray(arr), m, -go, -ge)
    score = np.asarray(out["score"])
    start = np.asarray(out["start"])
    strand = np.asarray(out["strand"])
    assert (score == qlen).all(), f"k={k}: scores {score}"
    for i, (st, rev) in enumerate(truth):
        assert strand[i] == (1 if rev else 0), (i, strand[i], rev)
        assert start[i] <= st <= start[i] + 200, (i, start[i], st)


def test_bigk_matches_host_engine(genome_world):
    """End-to-end fast pipeline at k=17 agrees with the exact engine."""
    from smalt_tpu.map.fastmode import run_fast_pipeline
    from smalt_tpu.map.engine import MapEngine, MapParams
    from smalt_tpu.map.pipeline import run_pipeline
    from smalt_tpu.seq.io import FastqReader
    refset, g = genome_world
    idx = build_index(refset, 17, 2)
    rng = np.random.default_rng(71)
    qlen = 90
    comp = str.maketrans("ACGT", "TGCA")
    recs = []
    for i in range(40):
        st = int(rng.integers(0, len(g) - qlen))
        s = list(g[st : st + qlen])
        for j in np.flatnonzero(rng.random(qlen) < 0.01):
            s[j] = "ACGT"[int(rng.integers(0, 4))]
        s = "".join(s)
        if i % 2:
            s = s.translate(comp)[::-1]
        recs.append(f"@k{i}\n{s}\n+\n{'I' * qlen}\n")
    d = os.path.dirname(refset_path(refset))
    fq = os.path.join(d, "bigk.fq")
    open(fq, "w").write("".join(recs))

    buf_fast = io.StringIO()
    run_fast_pipeline(refset, idx, fq, buf_fast, nthreads=1, batch=32)
    eng = MapEngine(refset, idx, MapParams())
    buf_exact = io.StringIO()
    run_pipeline(eng, FastqReader(fq), buf_exact, refset, nthreads=1)

    def parse(text):
        out = {}
        for ln in text.splitlines():
            if not ln or ln.startswith("@"):
                continue
            f = ln.split("\t")
            if int(f[1]) & 0x100:
                continue
            out[f[0]] = (int(f[1]) & 16, int(f[3]))
        return out

    fp, ep = parse(buf_fast.getvalue()), parse(buf_exact.getvalue())
    same = sum(1 for n in ep if n in fp and fp[n][0] == ep[n][0]
               and abs(fp[n][1] - ep[n][1]) <= 2)
    assert same >= 0.95 * len(ep), f"{same}/{len(ep)}"


def refset_path(refset):
    # RefSet doesn't retain its fasta path; use a tmp-adjacent file
    import tempfile
    return os.path.join(tempfile.gettempdir(), "x")


def test_sharded_bigk(genome_world):
    """k=16 on the RANGE-SHARDED index: sharded == single-device."""
    import jax
    if jax.device_count() < 4:
        pytest.skip("needs the virtual CPU mesh")
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from smalt_tpu.align import core as ali
    from smalt_tpu.parallel.mesh import (DeviceIndex, ShardedDeviceIndex,
                                         device_map_step,
                                         make_index_sharded_step)
    from smalt_tpu.seq import codec
    refset, g = genome_world
    idx = build_index(refset, 16, 2)
    m, go, ge = ali.make_score_matrix()
    rng = np.random.default_rng(97)
    qlen, B = 96, 16
    arr = np.full((B, qlen), 7, np.int32)
    comp = str.maketrans("ACGT", "TGCA")
    for i in range(B):
        st = int(rng.integers(0, len(g) - qlen))
        s = g[st : st + qlen]
        if i % 2:
            s = s.translate(comp)[::-1]
        arr[i] = codec.alpha(codec.encode(s.encode()))
    di = DeviceIndex.build(refset, idx)
    single = device_map_step(di, jnp.asarray(arr), m, -go, -ge)
    sdi = ShardedDeviceIndex.build(refset, idx, n_shards=2)
    assert sdi.words_lo is not None
    devs = np.array(jax.devices()[:4]).reshape(2, 2)
    mesh = Mesh(devs, ("dp", "ip"))
    step = make_index_sharded_step(sdi, mesh, m, -go, -ge)
    sharded = step(jnp.asarray(arr))
    for k in ("score", "start", "strand"):
        a = np.asarray(single[k])
        b = np.asarray(sharded[k])
        assert (a == b).all(), (k, a, b)
