"""Profile the aligner executor's round composition on the current
platform: rounds, dispatch counts per kind, and where wall-clock goes
(request packing / device wait / reply unpack / DP / generator
stepping / fetch).  Picks the next dispatch-fusion target.

Usage: python tools/profile_aligner.py [--genome 1000000] [--reads 32768]
           [--model single_align|rnaseq] [--sa-rate 8]
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
    ap.add_argument("--read-len", type=int, default=None)
    ap.add_argument("--sa-rate", type=int, default=8)
    ap.add_argument("--model", default="single_align",
                    choices=["single_align", "rnaseq"])
    ap.add_argument("--repeat", type=int, default=2)
    ap.add_argument("--isa-spec", type=int, default=None,
                    help="curgap speculative chunk (default: config)")
    args = ap.parse_args()

    import jax

    from bwt_tpu.utils import compile_cache

    compile_cache.enable()

    import jax.numpy as jnp

    import bwt_tpu
    from bwt_tpu import codec
    from bwt_tpu.models.batch_exec import BatchExecutor, QueryService

    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=args.genome).astype(np.uint8)
    rl = args.read_len or (80 if args.model == "single_align" else 50)
    reads = make_reads(codes, args.reads, rl, rng)

    print(f"building {args.genome}-base index (rate {args.sa_rate}) "
          f"on {jax.devices()[0].platform}...", flush=True)
    fmi = bwt_tpu.build_index(codes, sa_sample_rate=args.sa_rate)
    np.asarray(fmi.C)

    genome_dev = jax.jit(lambda g: g.astype(jnp.int32))(jnp.asarray(codes))

    for it in range(args.repeat):
        ex = None
        t0 = time.perf_counter()
        if args.model == "single_align":
            from bwt_tpu.models import aligner
            from bwt_tpu.config import DEFAULT as cfg

            svc = QueryService(fmi, genome_dev)
            svc.reset_reads()
            gens = []
            for r in reads:
                fwd = np.asarray(r, np.uint8)
                rev = codec.revcomp(fwd)
                fr = svc.add_read(fwd)
                rr = svc.add_read(rev)
                gens.append(aligner._read_gen(
                    codes, len(codes), fr, len(fwd), rr, len(rev),
                    cfg.anchor_len, fmi.isa_samples is not None,
                    cfg.spec_depth,
                    args.isa_spec if args.isa_spec else cfg.isa_spec_depth,
                ))
            ex = BatchExecutor(svc)
            results = ex.run(gens)
            naligned = sum(1 for p, _, _ in results if p)
        else:
            from bwt_tpu.models import rnaseq
            from bwt_tpu.config import DEFAULT as cfg

            svc = QueryService(fmi)
            svc.reset_reads()
            gens = []
            for r in reads:
                row = svc.add_read(np.asarray(r, np.uint8))
                gens.append(rnaseq.rna_seq_gen(
                    row, len(r), cfg.rnaseq_anchor_cutoff,
                    cfg.rnaseq_cont_cutoff, fmi.isa_samples is not None,
                    cfg.rnaseq_spec_depth,
                ))
            ex = BatchExecutor(svc)
            results = ex.run(gens)
            naligned = sum(1 for p in results if p != -1)
        dt = time.perf_counter() - t0
        print(f"iter {it}: {args.reads} reads in {dt:.2f}s "
              f"({args.reads / dt:.0f} reads/s), {naligned} aligned")
        st = ex.stats
        print(f"  rounds={st['rounds']} svc={st['svc_calls']} "
              f"dp={st['dp_calls']} rng={st['rng_calls']}")
        print("  " + " ".join(
            f"{k}={st.get(k, 0.0):.3f}s" for k in
            ("t_req", "t_dev", "t_reply", "t_dp", "t_dp_start",
             "t_dp_finish", "t_gen", "t_fetch")
        ))
        acct = sum(st[k] for k in
                   ("t_req", "t_dev", "t_reply", "t_dp", "t_gen", "t_fetch"))
        print(f"  accounted {acct:.2f}s of {dt:.2f}s", flush=True)


if __name__ == "__main__":
    main()
