"""Stage-level timing of the fused phase-B DP chain at the real bucket
shapes: the diagonal-scan fill alone, then the whole ``_dp_core``
(fill + endpoint + backtrack + RLE).

Each stage is its own jit whose output reduces to ONE scalar, so the
timing measures device work and not a (B,) column copy.

Usage: python tools/probe_dp_stages.py [--genome 1000000]
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
    ap.add_argument("--repeat", type=int, default=6)
    args = ap.parse_args()

    import jax

    from bwt_tpu.utils import compile_cache

    compile_cache.enable()

    import jax.numpy as jnp

    import bwt_tpu
    from bwt_tpu.config import DEFAULT
    from bwt_tpu.models import batch_exec as bx
    from bwt_tpu.models.batch_exec import QueryService
    from bwt_tpu.ops import align as align_ops

    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=args.genome).astype(np.uint8)
    print(f"building on {jax.devices()[0].platform}...", flush=True)
    fmi = bwt_tpu.build_index(codes, sa_sample_rate=4)
    np.asarray(fmi.C)
    svc = QueryService(fmi, codes, DEFAULT)
    reads = make_reads(codes, 32768, 80, rng)
    svc.add_reads_batch([np.asarray(r, np.uint8) for r in reads],
                        with_revcomp=True)
    bank = svc.bank
    genome_dev = svc.genome_dev
    scoring = svc.scoring

    # a 1 Mb / 32 k mutated-read bucket population, plus 4096 pairs
    # of 48x64
    SHAPES = [(16, 16, 32768), (16, 32, 8192), (32, 48, 1024),
              (48, 48, 128), (48, 64, 8), (48, 64, 4096)]

    def timeit(name, fn, *a):
        jax.block_until_ready(fn(*a))
        best = None
        for _ in range(args.repeat):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*a))
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        print(f"  {name:26s} {best*1e3:8.2f} ms", flush=True)
        return best

    for L1, L2, J in SHAPES:
        rlen = np.minimum(np.full(J, L1, np.int32), L1)
        glen = np.full(J, L2, np.int32)
        row = (np.arange(J, dtype=np.int32) * 2) % bank.shape[0]
        roff = np.zeros(J, np.int32)
        rrev = np.zeros(J, np.int32)
        gstart = (np.arange(J, dtype=np.int32) * 37) % (args.genome - L2)
        grev = np.zeros(J, np.int32)
        want_nw = np.ones(J, np.int32)
        f = [jnp.asarray(x) for x in
             (row, roff, rlen, rrev, gstart, glen, grev, want_nw)]

        @jax.jit
        def fill_only(row, roff, rlen, rrev, gstart, glen, grev, want_nw):
            k1 = jnp.arange(L1, dtype=jnp.int32)[None, :]
            ridx = jnp.where(rrev[:, None] == 1,
                             roff[:, None] + rlen[:, None] - 1 - k1,
                             roff[:, None] + k1)
            reads_ = jnp.take_along_axis(
                jnp.take(bank, row, axis=0),
                jnp.clip(ridx, 0, bank.shape[1] - 1), axis=1)
            reads_ = jnp.where(k1 < rlen[:, None], reads_, 0)
            k2 = jnp.arange(L2, dtype=jnp.int32)[None, :]
            gidx = jnp.where(grev[:, None] == 1,
                             gstart[:, None] + glen[:, None] - 1 - k2,
                             gstart[:, None] + k2)
            genomes = jnp.take(genome_dev,
                               jnp.clip(gidx, 0, genome_dev.shape[0] - 1))
            genomes = jnp.where(k2 < glen[:, None], genomes, 0)
            vals_d, ptrs_d = align_ops.dp_fill_diagonals(
                reads_, genomes, scoring)
            return vals_d.sum() + ptrs_d.astype(jnp.int32).sum()

        @jax.jit
        def full_core(row, roff, rlen, rrev, gstart, glen, grev, want_nw):
            out = bx._dp_core(
                bank, genome_dev, row, roff, rlen, rrev, gstart, glen,
                grev, want_nw, L1=L1, L2=L2, scoring=scoring)
            # maxloc, i, j, nrun, vals, counts, ops
            return (out[0].sum() + out[1].sum() + out[2].sum()
                    + out[3].astype(jnp.int32).sum()
                    + out[4].astype(jnp.int32).sum()
                    + out[5].astype(jnp.int32).sum())

        print(f"bucket {L1}x{L2} J={J}:", flush=True)
        t_fill = timeit("fill only", fill_only, *f)
        t_full = timeit("full _dp_core", full_core, *f)
        print(f"  {'post-fill (endpt+bt+rle)':26s} "
              f"{(t_full-t_fill)*1e3:8.2f} ms", flush=True)


if __name__ == "__main__":
    main()
