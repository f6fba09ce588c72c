"""Chromosome-scale stdout/value parity vs the C binaries (VERDICT r4
directive #6 — the automated form of what tools/bench_drivers.py
records manually in PARITY.md).

Marked ``gpu`` (a 33.5 Mb build plus 32 k reads is a GPU workload, not
a CPU-suite one) and env-gated: set ``BWT_SCALE_GENOME`` (e.g.
33554432) to run, with ``JAX_PLATFORMS=cuda,cpu`` and the C reference
present; skipped otherwise.  ``BWT_SCALE_BIG_READS`` (default 32768)
sets the read count.

What 1 Mb coverage (test_scale_parity.py) cannot catch and this does:
regressions that only manifest past 1 Mb — the chunk-pipeline paths
(>search_batch read counts run the 3-stage pipeline), the isa_window
adaptive scan-vs-window switch at wide genome scales, and the rate-4
serving index against the C binary's fixed rate-32 file (fileio.c:11-15
hardcodes len/32 samples; outputs must stay identical regardless).

Workload match: single_align.c:484-503 (per-read align + stdout
lines), rnaseqtest.c:313-327 (mutated 50-mers, printed values).
"""

import dataclasses
import os
import subprocess

import numpy as np
import pytest

pytestmark = [
    pytest.mark.gpu,
    pytest.mark.skipif(
        not os.environ.get("BWT_SCALE_GENOME"),
        reason="set BWT_SCALE_GENOME=<bases> (e.g. 33554432) to run the "
        "chromosome-scale parity sweep",
    ),
]

GLEN = int(os.environ.get("BWT_SCALE_GENOME", "0") or 0)
NREADS = int(os.environ.get("BWT_SCALE_BIG_READS", "32768"))


@pytest.fixture(scope="module")
def env(gpu, tmp_path_factory):
    import bwt_tpu
    from bwt_tpu import codec
    from bwt_tpu import io as bio

    tmp = tmp_path_factory.mktemp("scale_big")
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=GLEN).astype(np.uint8)
    g = codec.decode(codes)
    seqfile = tmp / "genome.txt"
    seqfile.write_text(g)
    # the C binaries read the reference-format rate-32 file; we serve
    # from a rate-4 index (identical outputs — the SA rate only trades
    # walk length for memory)
    idxfile = tmp / "genome.idx"
    bio.write_ref_index(bwt_tpu.build_index(codes), idxfile)
    fmi = bwt_tpu.build_index(codes, sa_sample_rate=4)
    np.asarray(fmi.C)
    return g, codes, fmi, seqfile, idxfile, tmp


def _mutated_reads(codes, n, length, rng):
    """rnaseqtest.c:317-322's XOR-a-base recipe (same as
    tools/bench_drivers.make_reads)."""
    starts = rng.integers(0, len(codes) - length, size=n)
    reads = codes[np.add.outer(starts, np.arange(length))].copy()
    pos = rng.integers(0, length, size=n)
    delta = rng.integers(1, 4, size=n)
    reads[np.arange(n), pos] ^= delta.astype(reads.dtype)
    return reads


def test_single_align_stdout_parity_at_chromosome_scale(env):
    from oracle import oracle

    from bwt_tpu.config import DEFAULT
    from bwt_tpu.models import aligner

    g, codes, fmi, seqfile, idxfile, tmp = env
    rng = np.random.default_rng(1)
    reads = _mutated_reads(codes, NREADS, 80, rng)
    lines = ["".join("ACGT"[c] for c in r) for r in reads]
    readfile = tmp / "reads80.txt"
    readfile.write_text("\n".join(lines) + "\n")
    res = subprocess.run(
        [str(oracle("single_align")), str(seqfile), str(idxfile),
         str(readfile)],
        capture_output=True, check=True,
    )
    # a sub-batch chunk size forces the 3-stage chunk pipeline — the
    # code path that only chunked (>search_batch) workloads execute
    cfg = dataclasses.replace(DEFAULT, search_batch=max(NREADS // 4, 1))
    got = aligner.format_ref_output(
        aligner.align_reads(fmi, codes, reads, config=cfg))
    assert got.encode() == res.stdout


def test_rna_seq_value_parity_at_chromosome_scale(env):
    from oracle import oracle

    from bwt_tpu.config import DEFAULT
    from bwt_tpu.models import rnaseq

    g, codes, fmi, seqfile, idxfile, tmp = env
    rng = np.random.default_rng(2)
    reads = _mutated_reads(codes, NREADS, 50, rng)
    lines = ["".join("ACGT"[c] for c in r) for r in reads]
    readfile = tmp / "reads50.txt"
    readfile.write_text("\n".join(lines) + "\n")
    res = subprocess.run(
        [str(oracle("rnaseq_main")), str(seqfile), str(readfile)],
        capture_output=True, check=True,
    )
    want = [int(t) for t in
            res.stdout.decode().replace("Should be right?", " ").split()]
    cfg = dataclasses.replace(DEFAULT, search_batch=max(NREADS // 4, 1))
    vals = rnaseq.rna_seq(fmi, reads, config=cfg)
    assert list(vals) == want
