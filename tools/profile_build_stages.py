"""Stage-level wall-clock split of the FULL index build (VERDICT r2 #5:
the prefix-doubling core alone is ~5 s @134 Mb, yet the end-to-end
build was measured at ~24 s — find the other ~19 s).

Stages timed warm (2nd iteration, per-stage block_until_ready):
  upload_s   — host uint8 -> device transfer
  widen_s    — uint8 -> int32 on device
  sort_s     — ops.suffix.suffix_array (the doubling core)
  finish_s   — _finish_index: BWT gather + ISA scatter + pack + buckets
  total_s    — one build_index-equivalent call chain

Usage: python tools/profile_build_stages.py [--sizes 33554432,134217728]
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
    ap.add_argument("--sizes", default="33554432,134217728")
    ap.add_argument("--repeat", type=int, default=2)
    ap.add_argument("--sa-rate", type=int, default=32)
    args = ap.parse_args()

    import jax

    from bwt_tpu.utils import compile_cache

    compile_cache.enable()

    import jax.numpy as jnp

    from bwt_tpu import index as index_mod
    from bwt_tpu.ops import suffix as sfx

    sync = jax.block_until_ready

    for size in [int(s) for s in args.sizes.split(",")]:
        rng = np.random.default_rng(0)
        host_codes = rng.integers(0, 4, size=size, dtype=np.uint8)
        for it in range(args.repeat):
            t0 = time.perf_counter()
            codes8 = sync(jnp.asarray(host_codes))
            t1 = time.perf_counter()
            codes = sync(index_mod._widen(codes8))
            t2 = time.perf_counter()
            sa = sync(sfx.suffix_array(codes))
            t3 = time.perf_counter()
            fmi = sync(
                index_mod._finish_index(codes, sa, size, args.sa_rate))
            t4 = time.perf_counter()
            del fmi, sa, codes, codes8
            if it == args.repeat - 1:
                total = t4 - t0
                print(
                    f"size={size/1e6:.1f}M total={total:.2f}s "
                    f"({size/1e6/total:.1f} Mb/s) "
                    f"upload={t1-t0:.2f}s widen={t2-t1:.2f}s "
                    f"sort={t3-t2:.2f}s finish={t4-t3:.2f}s",
                    flush=True,
                )


if __name__ == "__main__":
    main()
