"""Differential test: the C batched fast tail (fl_fast_tail_block)
must render byte-identical SAM to the Python FastTail.render loop for
the same device-pass outputs — mapped, unmapped, reverse-strand,
end-clipped, and contig-boundary reads."""
import io
import os

import numpy as np
import pytest

from smalt_tpu.seq.refset import RefSet
from smalt_tpu.index.table import build_index
from smalt_tpu.map.fastmode import (FastTail, encode_batch,
                                    iter_fastq_batches)
from smalt_tpu.report.report import ReportWriter


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(41)
    bases = np.array(list(b"ACGT"), np.uint8)
    contigs = [rng.choice(bases, n).tobytes().decode()
               for n in (6000, 4000)]
    d = tmp_path_factory.mktemp("ctail")
    fa = os.path.join(d, "g.fa")
    with open(fa, "w") as f:
        for i, c in enumerate(contigs):
            f.write(f">c{i}\n{c}\n")
    refset = RefSet.from_fasta(fa)
    idx = build_index(refset, 11, 2)
    return refset, idx, contigs


def _device_outs(refset, idx, seqs, Q):
    import jax.numpy as jnp
    from smalt_tpu.parallel.mesh import (DeviceIndex, device_map_step,
                                         window_len, window_pad)
    from smalt_tpu.align import core as ali
    di = DeviceIndex.build(refset, idx)
    m, go, ge = ali.make_score_matrix()
    arr = encode_batch(seqs, Q)
    out = device_map_step(di, jnp.asarray(arr), m, -go, -ge)
    return ({k: np.asarray(v) for k, v in out.items()},
            window_len(Q), window_pad(Q))


def test_c_tail_matches_python(world):
    refset, idx, contigs = world
    rng = np.random.default_rng(43)
    comp = str.maketrans("ACGT", "TGCA")
    names, seqs, quals = [], [], []
    qlen = 90
    genome = contigs[0]
    for i in range(48):
        kind = i % 6
        if kind == 5:
            s = "".join("ACGT"[j] for j in rng.integers(0, 4, qlen))
        else:
            st = int(rng.integers(0, len(genome) - qlen))
            s = genome[st : st + qlen]
            sl = list(s)
            # plant mismatches near the ends to force end clips
            if kind >= 2:
                for j in (0, 1, 2, qlen - 3, qlen - 2, qlen - 1):
                    sl[j] = "ACGT"[(("ACGT".index(sl[j]) + 1) % 4)]
            for j in np.flatnonzero(rng.random(qlen) < 0.03):
                sl[j] = "ACGT"[int(rng.integers(0, 4))]
            s = "".join(sl)
            if kind % 2:
                s = s.translate(comp)[::-1]
        names.append(f"q{i}/1".encode())
        seqs.append(s.encode())
        quals.append((33 + (np.arange(qlen) % 40)).astype(np.uint8)
                     .tobytes())
    # contig-edge reads
    for i, c in enumerate(contigs):
        s = c[-qlen:]
        names.append(f"edge{i}".encode())
        seqs.append(s.encode())
        quals.append(b"I" * qlen)

    Q = 96
    outs, wl, wp = _device_outs(refset, idx, seqs, Q)

    tail_py = FastTail(refset)
    buf_py = io.StringIO()
    writer = ReportWriter(buf_py, refset, fmt="sam", header=False)
    tail_py.render(names, seqs, quals, outs, wl, wp, Q, writer)

    tail_c = FastTail(refset)
    buf_c = io.StringIO()
    ok = tail_c.render_native(names, seqs, quals, outs, wl, wp, Q,
                              True, False, buf_c)
    assert ok, "native tail unavailable"
    a, b = buf_py.getvalue(), buf_c.getvalue()
    if a != b:
        for la, lb in zip(a.splitlines(), b.splitlines()):
            assert la == lb, f"\npy: {la}\nc : {lb}"
    assert a == b


def test_c_tail_hard_clip_x(world):
    """Hard-clip + extended-X variant goes through the same C path."""
    refset, idx, contigs = world
    rng = np.random.default_rng(47)
    qlen = 70
    genome = contigs[1]
    names, seqs, quals = [], [], []
    comp = str.maketrans("ACGT", "TGCA")
    for i in range(16):
        st = int(rng.integers(0, len(genome) - qlen))
        sl = list(genome[st : st + qlen])
        for j in (0, 1, qlen - 2, qlen - 1):
            sl[j] = "ACGT"[(("ACGT".index(sl[j]) + 1) % 4)]
        s = "".join(sl)
        if i % 2:
            s = s.translate(comp)[::-1]
        names.append(f"h{i}".encode())
        seqs.append(s.encode())
        quals.append(b"5" * qlen)
    Q = 80
    outs, wl, wp = _device_outs(refset, idx, seqs, Q)
    for soft, xmm in ((False, False), (True, True), (False, True)):
        tail_py = FastTail(refset)
        buf_py = io.StringIO()
        writer = ReportWriter(buf_py, refset, fmt="sam", header=False,
                              soft_clip=soft, x_mismatch=xmm)
        tail_py.render(names, seqs, quals, outs, wl, wp, Q, writer)
        tail_c = FastTail(refset)
        buf_c = io.StringIO()
        ok = tail_c.render_native(names, seqs, quals, outs, wl, wp, Q,
                                  soft, xmm, buf_c)
        assert ok
        assert buf_py.getvalue() == buf_c.getvalue(), (soft, xmm)


def test_c_pair_tail_matches_python(world):
    """fl_fast_tail_pairs must render byte-identical SAM to the Python
    render_pairs loop: proper pairs (pe/mp), rescued mates, unmapped
    mates, tied-mate elevation."""
    from smalt_tpu.results.pairs import LIB_PAIREDEND, LIB_MATEPAIR
    refset, idx, contigs = world
    rng = np.random.default_rng(101)
    comp = str.maketrans("ACGT", "TGCA")
    genome = contigs[0]
    qlen, insert = 80, 300
    names, seqs, quals = [], [], []
    for i in range(40):
        st = int(rng.integers(0, len(genome) - insert))
        frag = genome[st : st + insert]
        a = list(frag[:qlen])
        b = list(frag[-qlen:])
        for arr in (a, b):
            for j in np.flatnonzero(rng.random(qlen) < 0.02):
                arr[j] = "ACGT"[int(rng.integers(0, 4))]
        if i % 9 == 0:
            for j in range(0, qlen, 5):   # rescue target
                b[j] = "ACGT"[(("ACGT".index(b[j]) + 1) % 4)]
        if i % 13 == 0:
            a = ["ACGT"[v] for v in rng.integers(0, 4, qlen)]  # unmapped A
        names.append(f"pp{i}/1".encode())
        seqs.append("".join(a).encode())
        quals.append(b"I" * qlen)
    # build mate-B block (second half of the batch, same rng replay)
    rng = np.random.default_rng(101)
    for i in range(40):
        st = int(rng.integers(0, len(genome) - insert))
        frag = genome[st : st + insert]
        a = list(frag[:qlen])
        b = list(frag[-qlen:])
        for arr in (a, b):
            for j in np.flatnonzero(rng.random(qlen) < 0.02):
                arr[j] = "ACGT"[int(rng.integers(0, 4))]
        if i % 9 == 0:
            for j in range(0, qlen, 5):
                b[j] = "ACGT"[(("ACGT".index(b[j]) + 1) % 4)]
        names.append(f"pp{i}/2".encode())
        seqs.append("".join(b).translate(comp)[::-1].encode())
        quals.append(b"5" * qlen)

    Q = 80
    outs, wl, wp = _device_outs(refset, idx, seqs, Q)
    for libcode in (LIB_PAIREDEND, LIB_MATEPAIR):
        tail_py = FastTail(refset)
        buf_py = io.StringIO()
        writer = ReportWriter(buf_py, refset, fmt="sam", header=False)
        tail_py.render_pairs(names, seqs, quals, outs, wl, wp, Q,
                             0, 500, writer, libcode=libcode)
        tail_c = FastTail(refset)
        buf_c = io.StringIO()
        ok = tail_c.render_pairs_native(names, seqs, quals, outs, wl, wp,
                                        Q, 0, 500, True, False, buf_c,
                                        libcode=libcode)
        assert ok, "native pair tail unavailable"
        a, b = buf_py.getvalue(), buf_c.getvalue()
        if a != b:
            for la, lb in zip(a.splitlines(), b.splitlines()):
                assert la == lb, f"lib={libcode}\npy: {la}\nc : {lb}"
        assert a == b
