"""Phase-level wall-clock split for the aligner device engine at its
current configuration (seed jump + k-stage compaction + fused phase B).

Reports, warm best-of-N at 1 Mb / 32 k reads (configurable):
  * dispatch_s   — host time to build the bank + launch the automaton
  * automaton_s  — device time until mode is fetchable (phase A)
  * phaseB_s     — fused assemble (bucket counts fetch, DP buckets,
                   compose, slim fetch, host Cigar build)
  * fallback_s   — host-generator re-runs (count reported)
  * e2e_s        — align_reads end-to-end at the same shapes

Usage: python tools/profile_phases.py [--genome 1000000] [--reads 32768]
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from tools.bench_drivers import make_reads  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome", type=int, default=1_000_000)
    ap.add_argument("--reads", type=int, default=32768)
    ap.add_argument("--read-len", type=int, default=80)
    ap.add_argument("--sa-rate", type=int, default=8)
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--model", default="single_align",
                    choices=["single_align", "rnaseq"])
    ap.add_argument("--no-gc", action="store_true",
                    help="disable the cyclic GC during reps (isolates "
                    "collector pauses from real host work)")
    args = ap.parse_args()

    import jax

    from bwt_tpu.utils import compile_cache

    compile_cache.enable()

    import dataclasses

    import jax.numpy as jnp

    import bwt_tpu
    from bwt_tpu.config import DEFAULT
    from bwt_tpu.models import aligner, rnaseq
    from bwt_tpu.models.batch_exec import QueryService

    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=args.genome).astype(np.uint8)
    print(f"building {args.genome}-base rate-{args.sa_rate} index...",
          flush=True)
    fmi = bwt_tpu.build_index(codes, sa_sample_rate=args.sa_rate)
    np.asarray(fmi.C)
    genome_dev = jax.jit(lambda g: g.astype(jnp.int32))(jnp.asarray(codes))

    cfg = dataclasses.replace(DEFAULT, search_batch=args.reads)

    if args.model == "rnaseq":
        reads = make_reads(codes, args.reads, 50, rng)
        codes_list = [np.asarray(r, np.uint8) for r in reads]
        for rep in range(args.repeat):
            svc = QueryService(fmi, config=cfg)
            t0 = time.perf_counter()
            out = rnaseq._rna_chunk_dispatch(fmi, codes_list, cfg, svc)
            np.asarray(out[0])
            t1 = time.perf_counter()
            res = rnaseq._rna_chunk_finish(fmi, codes_list, cfg, svc, out)
            t2 = time.perf_counter()
            n_al = sum(1 for p in res if p != -1)
            print(f"rep {rep}: dispatch+automaton {t1-t0:.3f}s  "
                  f"finish {t2-t1:.3f}s  total {t2-t0:.3f}s "
                  f"({args.reads/(t2-t0):.0f} reads/s, {n_al} aligned)",
                  flush=True)
        return

    reads = make_reads(codes, args.reads, args.read_len, rng)
    codes_list = [np.asarray(r, np.uint8) for r in reads]

    from bwt_tpu.utils import profiling
    from bwt_tpu.utils.profiling import Phases

    import gc

    for rep in range(args.repeat):
        if args.no_gc:
            gc.collect()
            gc.disable()
        profiling.ACTIVE = prof = Phases()
        svc = QueryService(fmi, genome_dev, cfg)
        t0 = time.perf_counter()
        out = aligner._align_chunk_dispatch(
            fmi, len(codes), codes_list, cfg.anchor_len, None, svc,
            None, svc.seed)
        t_disp = time.perf_counter()
        np.asarray(out[0])  # mode: forces phase A completion
        t1 = time.perf_counter()
        iters = int(np.asarray(out[11])[0])
        results, fallback = aligner._assemble_logs_fused(
            svc, len(codes_list), out)
        t2 = time.perf_counter()
        nfb = len(fallback)
        if fallback:
            from bwt_tpu.models.batch_exec import BatchExecutor

            gens2 = [
                aligner._read_gen(codes, len(codes), 2 * k,
                                  len(codes_list[k]), 2 * k + 1,
                                  len(codes_list[k]), cfg.anchor_len,
                                  True, cfg.spec_depth, cfg.isa_spec_depth)
                for k in fallback
            ]
            for k, o in zip(fallback, BatchExecutor(svc).run(gens2)):
                results[k] = o
        t3 = time.perf_counter()
        n_al = sum(1 for p, _, _ in results if p)
        print(f"rep {rep}: dispatch {t_disp-t0:.3f}s  "
              f"automaton {t1-t_disp:.3f}s ({iters} iters)  "
              f"phaseB {t2-t1:.3f}s  "
              f"fallback {t3-t2:.3f}s ({nfb} lanes)  total {t3-t0:.3f}s "
              f"({args.reads/(t3-t0):.0f} reads/s, {n_al} aligned)",
              flush=True)
        print("  spans: " + "  ".join(
            f"{k}={v:.3f}s" for k, v in sorted(prof.totals.items())),
            flush=True)
        if args.no_gc:
            gc.enable()
    profiling.ACTIVE = None

    # end-to-end through the public driver (includes encode, chunking)
    best = None
    for _ in range(args.repeat):
        svc = QueryService(fmi, genome_dev, cfg)
        t0 = time.perf_counter()
        aligner.align_reads(fmi, codes, reads, config=cfg,
                            service=svc)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    print(f"e2e mono: {best:.3f}s ({args.reads/best:.0f} reads/s)",
          flush=True)

    # pipelined e2e (4 chunks) with span totals: shows the steady-state
    # overlap quality — wall minus span-sum is host think-time, wall
    # minus device spans is the non-overlapped remainder
    import dataclasses

    pcfg = dataclasses.replace(cfg, search_batch=max(args.reads // 4, 1))
    best = None
    for _ in range(args.repeat):
        svc = QueryService(fmi, genome_dev, pcfg)
        profiling.ACTIVE = prof = Phases()
        t0 = time.perf_counter()
        aligner.align_reads(fmi, codes, reads, config=pcfg,
                            service=svc)
        dt = time.perf_counter() - t0
        profiling.ACTIVE = None
        if best is None or dt < best:
            best, bprof = dt, prof
    print(f"e2e 4-chunk pipeline: {best:.3f}s "
          f"({args.reads/best:.0f} reads/s)", flush=True)
    print("  spans: " + "  ".join(
        f"{k}={v:.3f}s" for k, v in sorted(bprof.totals.items())),
        flush=True)


if __name__ == "__main__":
    main()
