"""End-to-end kilobase concordance: fast mode (banded device scorer +
banded host tail) vs the exact engine on the same noisy long reads
(BASELINE config 5's correctness axis; VERDICT r2 item 6).
"""
import io

import numpy as np
import pytest

from smalt_tpu.index.table import build_index
from smalt_tpu.map.fastmode import run_fast_pipeline
from smalt_tpu.parallel import mesh as M
from smalt_tpu.seq.refset import RefSet


def _mutate(rng, seq, sub=0.02, ind=0.015):
    out = []
    for ch in seq:
        r = rng.random()
        if r < ind / 2:
            continue
        if r < ind:
            out.append("ACGT"[int(rng.integers(0, 4))])
        if rng.random() < sub:
            ch = "ACGT"[int(rng.integers(0, 4))]
        out.append(ch)
    return "".join(out)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("longconc")
    rng = np.random.default_rng(19)
    bases = np.array(list(b"ACGT"), np.uint8)
    L = 200_000
    g = rng.choice(bases, L).tobytes().decode()
    fa = d / "g.fa"
    fa.write_text(">lg\n" + "\n".join(g[i:i + 60]
                                      for i in range(0, L, 60)) + "\n")
    comp = str.maketrans("ACGT", "TGCA")
    fq = d / "r.fq"
    n = 16
    truth = {}
    with open(fq, "w") as f:
        for i in range(n):
            RL = int(rng.integers(900, 1400))
            st = int(rng.integers(0, L - RL - 200))
            s = _mutate(rng, g[st:st + RL])
            if i % 2:
                s = s.translate(comp)[::-1]
            truth[f"L{i}"] = st
            f.write(f"@L{i}\n{s}\n+\n{'I' * len(s)}\n")
    refset = RefSet.from_fasta(str(fa))
    idx = build_index(refset, 13, 4)
    return refset, idx, str(fq), truth


def _parse(text):
    out = {}
    for ln in text.splitlines():
        if not ln or ln.startswith("@"):
            continue
        f = ln.split("\t")
        if int(f[1]) & 0x104:
            continue
        out[f[0]] = int(f[3])
    return out


def test_fast_vs_exact_kilobase(world):
    refset, idx, fq, truth = world
    buf = io.StringIO()
    run_fast_pipeline(refset, idx, fq, buf, nthreads=1, batch=16)
    fast = _parse(buf.getvalue())

    from smalt_tpu.map.engine import MapEngine, MapParams
    from smalt_tpu.map.pipeline import run_pipeline
    from smalt_tpu.seq.io import FastqReader
    from smalt_tpu import rand
    rand.ranseed(0)
    eng = MapEngine(refset, idx, MapParams())
    buf2 = io.StringIO()
    run_pipeline(eng, FastqReader(fq), buf2, refset)
    exact = _parse(buf2.getvalue())

    n_exact = len(exact)
    assert n_exact >= 14, f"exact engine mapped only {n_exact}/16"
    n_conc = sum(1 for name, pos in exact.items()
                 if name in fast and abs(fast[name] - pos) <= 100)
    assert n_conc >= 0.85 * n_exact, (n_conc, n_exact, fast, exact)
    # and both track the simulated truth
    n_truth = sum(1 for name, pos in fast.items()
                  if abs(pos - 1 - truth[name]) <= 150)
    assert n_truth >= 0.85 * len(fast), (n_truth, len(fast))


def test_anchor_is_pure_accelerator(world, monkeypatch):
    """The banded scorer's argmax anchor only CENTRES the host tail's
    narrow band — a below-device-score result falls back to the wide
    band.  On this fixture suppressing every anchor (tis = -1, the
    legacy no-anchor contract) leaves the fast-mode SAM byte-identical;
    in general the contract is score >= device score (an adversarial
    wide-band margin alignment may differ — fastmode.py contract
    note), so this is a fixture-level regression guard."""
    refset, idx, fq, truth = world
    scores = M.sw_scores

    def scores_noanchor(*a, track=False, **k):
        out = scores(*a, track=track, **k)
        if track:
            sc, ti, tj = out
            import jax.numpy as jnp
            return sc, jnp.full_like(ti, -1), jnp.full_like(tj, -1)
        return out

    with_anchor = io.StringIO()
    run_fast_pipeline(refset, idx, fq, with_anchor, nthreads=1,
                      batch=16)

    monkeypatch.setattr(M, "sw_scores", scores_noanchor)
    without = io.StringIO()
    run_fast_pipeline(refset, idx, fq, without, nthreads=1, batch=16)
    assert with_anchor.getvalue() == without.getvalue()
