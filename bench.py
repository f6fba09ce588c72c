"""Headline benchmark + honest sub-metrics, one JSON line, on one GPU.

The reference's query benchmark is fmitest.c:150-165 — 10 M x 12-bp
``reverse_search`` calls over 4 pthreads on a synthetic genome, with
the index built by the histogram suffix sort (fmitest.c:143-149).
Here the same workload runs as lockstep batched backward search on one
GPU, reported at three memoization tiers plus locate and build:

  * ``searches_raw``     — the un-memoized lockstep LF loop: L steps x
    2 rank row-gathers per read.  This is the honest per-step rate that
    every read longer than any seed table runs at.
  * ``searches_k8``      — first 8 steps answered by a 256 KiB seed
    table (the moral analog of the reference's own 1 KiB byte-lookup
    memo, seqindex.c:115-138), remaining steps live.
  * ``searches_k12``     — fully seeded 12-bp workload (one row-gather
    per query); the headline number for the fmitest config.
  * ``locate30``         — reference-exact locate() of 30-mers
    (backward search + LF-walk to a sampled SA entry), at the
    reference's rate-32 SA sampling and at rate 4.
  * ``build_mbps``       — device-warm index build rate.

All tiers produce bit-identical search results (tests/test_seed.py).
Prints ONE JSON line with the headline metric plus an ``extras`` dict.
"""

import argparse
import json
import time

import jax
import numpy as np


def _bench(fn, *args, steps):
    jax.block_until_ready(fn(*args))  # compile + warm
    t0 = time.perf_counter()
    out = None
    for _ in range(steps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / steps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome", type=int, default=None, help="genome length (bases)")
    ap.add_argument("--batch", type=int, default=None, help="reads per step")
    ap.add_argument("--plen", type=int, default=12, help="pattern length (fmitest: 12)")
    ap.add_argument("--steps", type=int, default=None, help="timed steps")
    args = ap.parse_args()

    import sys

    from bwt_tpu.utils import compile_cache, profiling

    platform = jax.devices()[0].platform
    if platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found none (platform "
                 f"{platform!r})")
    compile_cache.enable()
    # 2^25 bases ~ a human chromosome 21 (chromosome-scale)
    glen = args.genome or (1 << 25)
    batch = args.batch or (1 << 21)
    steps = args.steps or 10

    import jax.numpy as jnp

    import bwt_tpu
    from bwt_tpu.ops import search

    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=glen).astype(np.uint8)  # fmitest.c:128-129

    print(f"bench: building {glen}-base index on {platform}...",
          file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    fmi = bwt_tpu.build_index(codes)
    jax.block_until_ready(fmi.bwt_words)
    build_s = time.perf_counter() - t0
    print(f"bench: index built in {build_s:.1f}s", file=sys.stderr, flush=True)

    # device-warm build rate (codes already uploaded, jits compiled)
    codes_dev = jnp.asarray(codes)
    warm_s = _bench(lambda c: bwt_tpu.build_index(c), codes_dev, steps=2)
    build_mbps = glen / warm_s / 1e6
    print(f"bench: warm build {warm_s:.1f}s ({build_mbps:.1f} Mb/s)",
          file=sys.stderr, flush=True)

    def make_patterns(plen, n):
        # every pattern from its own random start (vectorized outer
        # -index slice) — an earlier version tiled 2^16 unique patterns
        # to fill the batch, which repeated gather rows and could
        # flatter the memoized tiers
        starts = rng.integers(0, glen - plen, size=n)
        pats = codes[np.add.outer(starts, np.arange(plen))]
        widen = jax.jit(lambda x: x.astype(jnp.int32))
        return (
            widen(jnp.asarray(pats)),  # uint8 upload, widen on device
            jnp.asarray(np.full((n,), plen, np.int32)),
        )

    extras = {"build_s": round(build_s, 1), "build_mbps": round(build_mbps, 2),
              "genome": glen, "batch": batch, "platform": platform,
              "device_kind": jax.devices()[0].device_kind,
              "card": profiling.gpu_card()}

    pats, lens = make_patterns(args.plen, batch)

    # --- raw (un-memoized) lockstep LF loop ---------------------------
    dt = _bench(
        lambda p, l: search.reverse_search(fmi, p, l), pats, lens, steps=steps
    )
    extras["searches_raw_per_s"] = round(batch / dt, 1)
    print(f"bench: raw {batch/dt/1e6:.2f} M/s", file=sys.stderr, flush=True)

    # --- light seed (k=8, 256 KiB — analog of the reference's 1 KiB
    # byte-count memo) -------------------------------------------------
    seed8 = search.build_seed_table(fmi, k=min(8, args.plen))
    jax.block_until_ready(seed8.rows)
    dt = _bench(
        lambda p, l: search.reverse_search(fmi, p, l, seed_table=seed8),
        pats, lens, steps=steps,
    )
    extras["searches_k8_per_s"] = round(batch / dt, 1)
    print(f"bench: k8 {batch/dt/1e6:.2f} M/s", file=sys.stderr, flush=True)

    # --- full seed (k=12) ---------------------------------------------
    seed_k = 12
    seed = search.build_seed_table(fmi, k=min(seed_k, args.plen))
    jax.block_until_ready(seed.rows)
    dt = _bench(
        lambda p, l: search.reverse_search(fmi, p, l, seed_table=seed),
        pats, lens, steps=steps,
    )
    sps = batch / dt
    extras[f"searches_k{seed_k}_per_s"] = round(sps, 1)
    print(f"bench: k{seed_k} {sps/1e6:.2f} M/s", file=sys.stderr, flush=True)

    # --- locate of 30-mers --------------------------------------------
    # at the reference's serialized SA rate (32)...
    lbatch = batch // 4
    lpats, llens = make_patterns(30, lbatch)
    lsteps = max(steps // 2, 1)
    dt = _bench(
        lambda p, l: search.locate(fmi, p, l, seed_table=seed),
        lpats, llens, steps=lsteps,
    )
    extras["locate30_per_s"] = round(lbatch / dt, 1)
    print(f"bench: locate30 {lbatch/dt/1e6:.3f} M/s", file=sys.stderr, flush=True)

    # 16-mers on the rate-32 index: the C searchtest.c:77-94 workload
    # (1M random 16-bp locates), for the PARITY.md wall-clock row
    l16pats, l16lens = make_patterns(16, lbatch)
    dt = _bench(
        lambda p, l: search.locate(fmi, p, l, seed_table=seed),
        l16pats, l16lens, steps=lsteps,
    )
    extras["locate16_per_s"] = round(lbatch / dt, 1)
    print(f"bench: locate16 {lbatch/dt/1e6:.3f} M/s", file=sys.stderr,
          flush=True)

    # ...and on a rate-4 index (identical outputs, +0.875 B/base HBM),
    # where the LF walk shortens 8x.  (A seed-and-verify locate_fast
    # was benched here through round 3 and removed: it lost to plain
    # locate in both SA-rate regimes — see ops/search.py's note.)
    fmi4 = bwt_tpu.build_index(codes, sa_sample_rate=4)
    seed4 = search.build_seed_table(fmi4, k=min(seed_k, 12))
    jax.block_until_ready(seed4.rows)
    dt = _bench(
        lambda p, l: search.locate(fmi4, p, l, seed_table=seed4),
        lpats, llens, steps=lsteps,
    )
    extras["locate30_r4_per_s"] = round(lbatch / dt, 1)
    print(f"bench: locate30_r4 {lbatch/dt/1e6:.3f} M/s", file=sys.stderr, flush=True)

    # --- alignment drivers (fused executor; rate-4 index) -------------
    from bwt_tpu.models import aligner, rnaseq
    from bwt_tpu.models.batch_exec import QueryService

    # one mono batch per driver: the automaton's round count barely
    # drops with fewer lanes, so chunk pipelining pays two near-full
    # automaton runs to overlap one phase B (an A/B on the earlier
    # accelerator; unmeasured on the H100)
    import dataclasses

    from bwt_tpu.config import DEFAULT

    ab = min(batch // 32, 32768)
    astarts = rng.integers(0, glen - 80, size=ab)
    areads = codes[np.add.outer(astarts, np.arange(80))].copy()
    mpos = rng.integers(0, 80, size=ab)
    areads[np.arange(ab), mpos] ^= rng.integers(1, 4, size=ab).astype(np.uint8)
    rreads = np.ascontiguousarray(areads[:, :50])

    genome_dev = jax.jit(lambda g: g.astype(jnp.int32))(codes_dev)
    acfg = dataclasses.replace(DEFAULT, search_batch=max(ab, 64))

    def run_sa():
        return aligner.align_reads(
            fmi4, codes, areads, config=acfg,
            service=QueryService(fmi4, genome_dev, acfg),
        )

    def run_rna():
        return rnaseq.rna_seq(fmi4, rreads, service=QueryService(fmi4))

    run_sa()  # warm/compile
    t0 = time.perf_counter()
    run_sa()
    extras["single_align_reads_per_s"] = round(ab / (time.perf_counter() - t0), 1)
    print(f"bench: single_align {extras['single_align_reads_per_s']:.0f} reads/s",
          file=sys.stderr, flush=True)
    run_rna()
    t0 = time.perf_counter()
    run_rna()
    extras["rna_seq_reads_per_s"] = round(ab / (time.perf_counter() - t0), 1)
    print(f"bench: rna_seq {extras['rna_seq_reads_per_s']:.0f} reads/s",
          file=sys.stderr, flush=True)

    print(
        json.dumps(
            {
                "metric": "exact_backward_searches_per_sec_per_chip",
                "value": round(sps, 1),
                "unit": f"searches/s ({args.plen}bp k{seed_k}-seeded, "
                        f"{glen}b genome, {platform})",
                "vs_baseline": round(sps / 10_000_000, 4),
                "extras": extras,
            }
        )
    )


if __name__ == "__main__":
    main()
