"""Phase-B DP cost at the bucket shapes a real ``single_align`` run
dispatches.

1. Aligns mutated reads (one XOR-ed base each, chip_smoke.py's recipe)
   against a seeded genome once, recording every DP bucket the fused
   phase B dispatches: (L1, L2, J capacity, true job count) per
   ``aligner._dp_scatter_bucket`` call.
2. Times ``align_reads`` end to end (median of ``--e2e`` warm runs).
3. Times ``batch_exec._dp_step`` at each distinct (L1, L2, J) with
   synthetic full-length jobs (median of ``--repeat`` warm calls) and
   weights each by how often the run dispatched it; with
   ``--scan-unroll 1,4,8`` once per ``align.DP_SCAN_UNROLL`` value.

It touches only ``build_index``, ``align_reads``,
``aligner._dp_scatter_bucket`` and ``batch_exec._dp_step``, so the same
file runs in two checkouts: to A/B a DP change, run it in the old and
the new tree on one device, in the order old, new, new, old.

Usage: python tools/ab_dp_fill.py [--genome 134217728] [--reads 32768]
           [--read-len 80] [--sa-rate 4] [--repeat 20] [--e2e 7]
           [--scan-unroll 1,4,8] [--json out.json]
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def record_buckets(aligner, fn):
    """Run ``fn()`` with ``aligner._dp_scatter_bucket`` wrapped; returns
    (fn's result, [(L1, L2, J, jobs)] per dispatch)."""
    seen = []
    orig = aligner._dp_scatter_bucket

    def wrapped(*args, **kw):
        jk, head_end = args[8], args[12]
        seen.append((kw["L1"], kw["L2"], int(jk.shape[0]),
                     int(np.sum(np.asarray(jk) < head_end.shape[0]))))
        return orig(*args, **kw)

    aligner._dp_scatter_bucket = wrapped
    try:
        return fn(), seen
    finally:
        aligner._dp_scatter_bucket = orig


def histogram(seen):
    """{(L1, L2, J): (dispatches, jobs)} over recorded dispatches."""
    out = collections.defaultdict(lambda: [0, 0])
    for L1, L2, J, jobs in seen:
        out[(L1, L2, J)][0] += 1
        out[(L1, L2, J)][1] += jobs
    return {k: tuple(v) for k, v in sorted(out.items())}


def time_dp_step(bx, bank, genome_dev, scoring, L1, L2, J, glen, repeat):
    """Median seconds of a warm ``_dp_step`` on J synthetic full-length
    jobs of an L1 x L2 bucket."""
    import jax
    import jax.numpy as jnp

    f = [jnp.asarray(c) for c in (
        (np.arange(J, dtype=np.int32) * 2) % bank.shape[0],    # row
        np.zeros(J, np.int32),                                 # roff
        np.full(J, min(L1, bank.shape[1]), np.int32),          # rlen
        np.zeros(J, np.int32),                                 # rrev
        (np.arange(J, dtype=np.int32) * 37) % (glen - L2),     # gstart
        np.full(J, L2, np.int32),                              # glen
        np.zeros(J, np.int32),                                 # grev
        np.ones(J, np.int32),                                  # want_nw
    )]

    def step():
        return bx._dp_step(bank, genome_dev, *f, L1=L1, L2=L2,
                           scoring=scoring)

    jax.block_until_ready(step())
    ts = []
    for _ in range(repeat):
        t0 = time.perf_counter()
        jax.block_until_ready(step())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome", type=int, default=1 << 27)
    ap.add_argument("--reads", type=int, default=32768)
    ap.add_argument("--read-len", type=int, default=80)
    ap.add_argument("--sa-rate", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeat", type=int, default=20)
    ap.add_argument("--e2e", type=int, default=7)
    ap.add_argument("--scan-unroll", default=None,
                    help="comma-separated DP scan unroll factors to time")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()

    import jax

    from bwt_tpu.utils import compile_cache

    compile_cache.enable()

    import bwt_tpu
    from bwt_tpu.config import DEFAULT
    from bwt_tpu.models import aligner
    from bwt_tpu.models import batch_exec as bx

    rng = np.random.default_rng(args.seed)
    genome = rng.integers(0, 4, size=args.genome, dtype=np.uint8)
    starts = rng.integers(0, args.genome - args.read_len, size=args.reads)
    reads = genome[np.add.outer(starts, np.arange(args.read_len))].copy()
    hit = rng.integers(0, args.read_len, size=args.reads)
    reads[np.arange(args.reads), hit] ^= rng.integers(
        1, 4, size=args.reads).astype(np.uint8)

    fmi = bwt_tpu.build_index(genome, sa_sample_rate=args.sa_rate)
    np.asarray(fmi.C)
    dev = jax.devices()[0]
    print(f"{dev.platform} {dev.device_kind}: {args.genome} bases, "
          f"{args.reads} x {args.read_len}-mers, rate {args.sa_rate}",
          flush=True)

    res, seen = record_buckets(
        aligner, lambda: aligner.align_reads(fmi, genome, reads))
    ref = aligner.format_ref_output(res)
    hist = histogram(seen)
    print(f"phase-B DP dispatches: {len(seen)}", flush=True)
    for (L1, L2, J), (calls, jobs) in hist.items():
        print(f"  bucket {L1}x{L2} J={J}: {calls} call(s), {jobs} jobs",
              flush=True)

    walls = []
    for _ in range(args.e2e):
        t0 = time.perf_counter()
        out = aligner.align_reads(fmi, genome, reads)
        walls.append(time.perf_counter() - t0)
        assert aligner.format_ref_output(out) == ref, "output changed"
    e2e = statistics.median(walls)
    print(f"single_align e2e: median {e2e:.4f} s "
          f"({args.reads / e2e:.1f} reads/s) over "
          f"{[round(w, 4) for w in walls]}", flush=True)

    svc = bx.QueryService(fmi, genome, DEFAULT)
    svc.add_reads_batch([np.asarray(r, np.uint8) for r in reads[:64]],
                        with_revcomp=True)
    bank, genome_dev, scoring = svc.bank, svc.genome_dev, svc.scoring
    unrolls = ([int(u) for u in args.scan_unroll.split(",")]
               if args.scan_unroll else [None])
    shapes = {}
    weighted = {}
    for unroll in unrolls:
        if unroll is not None:
            from bwt_tpu.ops import align as align_ops

            align_ops.DP_SCAN_UNROLL[jax.default_backend()] = unroll
            jax.clear_caches()
        tag = "" if unroll is None else f" unroll={unroll}"
        total = 0.0
        for (L1, L2, J), (calls, _jobs) in hist.items():
            med = time_dp_step(bx, bank, genome_dev, scoring, L1, L2, J,
                               args.genome, args.repeat)
            shapes[f"{L1}x{L2}x{J}{tag.replace(' ', '_')}"] = {
                "calls": calls, "ms": med * 1e3}
            total += calls * med
            print(f"  _dp_step {L1}x{L2} J={J}{tag}: median "
                  f"{med * 1e3:.3f} ms", flush=True)
        weighted[unroll] = total * 1e3
        print(f"dispatch-weighted _dp_step total{tag}: {total * 1e3:.3f} "
              f"ms per align_reads call", flush=True)

    if args.json:
        with open(args.json, "w") as fh:
            json.dump({
                "device": dev.device_kind, "genome": args.genome,
                "reads": args.reads, "read_len": args.read_len,
                "dispatches": [list(s) for s in seen],
                "e2e_s": walls, "dp_step": shapes,
                "dp_weighted_ms": {str(k): v for k, v in weighted.items()},
            }, fh, indent=1)


if __name__ == "__main__":
    main()
