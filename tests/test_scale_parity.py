"""At-scale parity vs the C binaries: 1 Mb genome, thousands of reads
(VERDICT round-1 weak #6 / directive 8 — the small-genome parity suite
lives in test_models.py; this file re-runs the same byte/value
comparisons at the BASELINE-style scale).

Runtime control: the default run uses 1 Mb / 512 reads per driver
(~2 min on CPU with a warm compile cache).  Set BWT_SCALE_READS=2000
for the full 2 k-read sweep.
"""

import os
import subprocess

import numpy as np
import pytest

import bwt_tpu
from bwt_tpu import codec
from bwt_tpu import io as bio
from bwt_tpu.models import aligner, exact, rnaseq

from oracle import oracle
from test_models import make_reads

GLEN = 1_000_000
NREADS = int(os.environ.get("BWT_SCALE_READS", "512"))


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("scale")
    g = codec.random_genome(GLEN, seed=1234)
    seqfile = tmp / "genome.txt"
    seqfile.write_text(g)
    fmi = bwt_tpu.build_index(g)
    idxfile = tmp / "genome.idx"
    bio.write_ref_index(fmi, idxfile)
    return g, fmi, seqfile, idxfile, tmp


def test_sharded_sa_at_scale(env):
    """The distributed build must stay bit-exact at the 1 Mb scale on
    the 8-shard mesh (round counts / shard boundary interactions only
    show up past toy sizes)."""
    from bwt_tpu import parallel
    from bwt_tpu.ops import suffix

    g, _fmi, _seq, _idx, _tmp = env
    codes = codec.encode_genome(g)
    mesh = parallel.make_mesh(8, tp=8)
    got = parallel.sharded_suffix_array(codes, mesh)
    want = np.asarray(suffix.suffix_array(codes))
    assert np.array_equal(got, want)


def test_index_bytes_at_1mb(env):
    g, fmi, seqfile, idxfile, tmp = env
    res = subprocess.run(
        [str(oracle("build_index")), str(seqfile), str(tmp / "ref.idx")],
        capture_output=True, check=True,
    )
    assert (tmp / "ref.idx").read_bytes() == idxfile.read_bytes()


def test_single_align_stdout_parity_at_scale(env, rng):
    g, fmi, seqfile, idxfile, tmp = env
    reads = make_reads(rng, g, NREADS)
    readfile = tmp / "reads.txt"
    readfile.write_text("\n".join(reads) + "\n")
    res = subprocess.run(
        [str(oracle("single_align")), str(seqfile), str(idxfile), str(readfile)],
        capture_output=True, check=True,
    )
    got = aligner.format_ref_output(aligner.align_reads(fmi, g, reads))
    assert got == res.stdout.decode()


def test_rna_seq_parity_at_scale(env, rng):
    g, fmi, seqfile, _, tmp = env
    reads = []
    for _ in range(NREADS):
        j = int(rng.integers(0, len(g) - 50))
        r = list(g[j : j + 50])
        k = int(rng.integers(0, 50))
        r[k] = "ACGT"[("ACGT".index(r[k])) ^ int(rng.integers(1, 4))]
        reads.append("".join(r))
    readfile = tmp / "reads_rna.txt"
    readfile.write_text("\n".join(reads) + "\n")
    res = subprocess.run(
        [str(oracle("rnaseq_main")), str(seqfile), str(readfile)],
        capture_output=True, check=True,
    )
    want = [
        int(t) for t in res.stdout.decode().replace("Should be right?", " ").split()
    ]
    got = list(rnaseq.rna_seq(fmi, reads))
    assert got == want


def test_search_reads_anchor_replay_at_scale(env, rng):
    """Lockstep anchor_scan vs a direct host replay of the anchor loop
    (search_reads.c:115-133 semantics) on a 1 Mb index."""
    g, fmi, *_ = env
    codes = codec.encode_genome(g)
    n = max(NREADS // 4, 128)
    reads = []
    for _ in range(n):
        j = int(rng.integers(0, GLEN - 60))
        r = codes[j : j + 60].copy()
        if rng.random() < 0.5:
            k = int(rng.integers(0, 60))
            r[k] ^= int(rng.integers(1, 4))
        reads.append(r)
    pats = np.stack(reads).astype(np.int32)
    lens = np.full((n,), 60, np.int32)
    nm, pos = exact.anchor_scan(fmi, pats, lens)
    nm, pos = np.asarray(nm), np.asarray(pos)

    # host replay driven by the already-tested batched mms/unc_sa ops,
    # one read at a time (sequential semantics)
    from bwt_tpu.ops import search as search_ops

    idxs = rng.integers(0, n, size=12)
    for b in idxs:
        ln = 60
        count, last = 0, -1
        while ln > 20:
            m, sp, _ = (
                int(np.asarray(x)[0])
                for x in search_ops.mms(
                    fmi, pats[b : b + 1], np.asarray([max(ln, 1)], np.int32)
                )
            )
            if m >= 20:
                count += 1
                last = int(np.asarray(search_ops.unc_sa(fmi, np.asarray([sp])))[0])
                ln -= m
            else:
                ln -= 1
        assert count == nm[b] and (count == 0 or last == pos[b]), b
