"""Measure where suffix_array's prefix-doubling time goes vs size
(VERDICT r2 #5: 17.7 Mb/s warm @33.5 Mb decayed to ~5.6 Mb/s @134 Mb).

Runs the doubling rounds as a host loop of separately-jitted stages —
initial ranks, the k-shift slice, the 2-key sort, the re-rank scatter
— timing each warm (per-stage block_until_ready), and reports round
counts and per-stage seconds at each size.

Usage: python tools/probe_build.py [--sizes 33554432,134217728]
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="8388608,33554432,134217728")
    ap.add_argument("--repeat", type=int, default=2)
    args = ap.parse_args()

    import jax

    from bwt_tpu.utils import compile_cache

    compile_cache.enable()

    import jax.numpy as jnp

    from bwt_tpu.ops import suffix as sfx

    dtype = jnp.int32

    @jax.jit
    def init_ranks(codes):
        return sfx._initial_ranks(codes, codes.shape[0], dtype)

    @jax.jit
    def shift(r, k):
        m = r.shape[0]
        fill = jnp.full((m,), -1, dtype)
        return jax.lax.dynamic_slice(jnp.concatenate([r, fill]), (k,), (m,))

    @jax.jit
    def sort3(r, r2, idx):
        return jax.lax.sort((r, r2, idx), num_keys=2)

    @jax.jit
    def rerank(kr, kr2, sa):
        m = kr.shape[0]
        changed = jnp.concatenate(
            [jnp.zeros((1,), dtype),
             ((kr[1:] != kr[:-1]) | (kr2[1:] != kr2[:-1])).astype(dtype)]
        )
        ranks_sorted = jnp.cumsum(changed)
        new_r = jnp.zeros((m,), dtype).at[sa].set(ranks_sorted)
        return new_r, ranks_sorted[-1] == m - 1

    for size in [int(s) for s in args.sizes.split(",")]:
        rng = np.random.default_rng(0)
        codes = jnp.asarray(rng.integers(0, 4, size=size, dtype=np.uint8))
        m = size + 1
        idx = jnp.arange(m, dtype=dtype)
        stats = {"init": 0.0, "shift": 0.0, "sort": 0.0, "rerank": 0.0}
        best = None
        for it in range(args.repeat):
            t0 = time.perf_counter()
            r = jax.block_until_ready(
                init_ranks(codes.astype(jnp.int32)))
            t1 = time.perf_counter()
            stats["init"] = t1 - t0
            k = sfx._INIT_K
            rounds = 0
            while True:
                ta = time.perf_counter()
                r2 = jax.block_until_ready(shift(r, jnp.asarray(k, dtype)))
                tb = time.perf_counter()
                kr, kr2, sa = jax.block_until_ready(sort3(r, r2, idx))
                tc = time.perf_counter()
                (r, done) = jax.block_until_ready(rerank(kr, kr2, sa))
                td = time.perf_counter()
                stats["shift"] += tb - ta
                stats["sort"] += tc - tb
                stats["rerank"] += td - tc
                rounds += 1
                k *= 2
                if bool(done) or k >= m:
                    break
            total = time.perf_counter() - t0
            best = total if best is None else min(best, total)
            if it == args.repeat - 1:
                print(
                    f"size={size/1e6:.1f}M rounds={rounds} total={total:.2f}s "
                    f"({size/1e6/total:.1f} Mb/s) " +
                    " ".join(f"{k_}={v:.2f}s" for k_, v in stats.items()),
                    flush=True,
                )
            stats = {k_: 0.0 for k_ in stats}


if __name__ == "__main__":
    main()
