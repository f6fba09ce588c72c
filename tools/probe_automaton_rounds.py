"""Cumulative-cost curve of the aligner automaton's outer rounds.

Times `_align_automaton` at increasing ``cap_steps`` (the while-loop
iteration cap): the deltas between consecutive caps are the device
cost of each outer-round band, separating the full-width early rounds
from the compacted tail.  Each cap is its own jit signature (compiles
cache across runs via .jax_cache).

Usage: python tools/probe_automaton_rounds.py [--genome 1000000]
           [--reads 32768] [--caps 1,2,3,5,7,9,11,13,15,17]
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
    ap.add_argument("--caps", default="1,2,3,5,7,9,11,13,15,17")
    ap.add_argument("--repeat", type=int, default=3)
    args = ap.parse_args()

    import jax

    from bwt_tpu.utils import compile_cache

    compile_cache.enable()

    import jax.numpy as jnp

    import bwt_tpu
    from bwt_tpu.config import DEFAULT
    from bwt_tpu.models import aligner
    from bwt_tpu.models.batch_exec import QueryService

    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=args.genome).astype(np.uint8)
    print(f"building {args.genome}-base rate-{args.sa_rate} index on "
          f"{jax.devices()[0].platform}...", flush=True)
    fmi = bwt_tpu.build_index(codes, sa_sample_rate=args.sa_rate)
    np.asarray(fmi.C)

    svc = QueryService(fmi, codes, DEFAULT)
    reads = make_reads(codes, args.reads, args.read_len, rng)
    codes_list = [np.asarray(r, np.uint8) for r in reads]
    svc.reset_reads()
    _, lens = svc.add_reads_batch(codes_list, with_revcomp=True)
    bank = svc.bank
    Bp = bank.shape[0] // 2
    lens_p = np.zeros(Bp, np.int32)
    lens_p[: len(codes_list)] = lens
    live0 = np.zeros(Bp, bool)
    live0[: len(codes_list)] = True
    seed = svc.seed
    compact = aligner._compact_ladder(Bp)
    glen = jnp.int32(len(codes))

    def run(cap):
        out = aligner._align_automaton(
            fmi, bank, jnp.asarray(lens_p), jnp.asarray(live0), glen,
            None if seed is None else seed.rows,
            anchor_len=aligner.DEFAULT_ANCHOR_LEN, resolve=False,
            compact=compact, cap_steps=cap,
            seed_k=0 if seed is None else seed.k,
        )
        live = int(np.asarray(jnp.sum(out[10])))  # capped lanes
        return live

    prev = 0.0
    for cap in [int(c) for c in args.caps.split(",")]:
        live = run(cap)  # compile + warm
        best = None
        for _ in range(args.repeat):
            t0 = time.perf_counter()
            live = run(cap)
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        print(f"cap {cap:3d}: {best*1e3:7.1f} ms  (+{(best-prev)*1e3:6.1f})"
              f"  live={live}", flush=True)
        prev = best


if __name__ == "__main__":
    main()
