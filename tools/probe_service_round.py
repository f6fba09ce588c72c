"""Dissect ONE fused service round's device cost at driver width.

The aligner automaton's 0.25 s (warm, 1 Mb / 32 k lanes, 15 outer
rounds) is some mix of: the inner LF loop (2 rank row-gathers/step),
the free-rider unc_sa walk (<= sa_rate LF steps, every round), the
(B, Lb) bank/rev prep, and the OP_MEXT window scan.  This probe times
jitted `_service_core` dispatches that isolate each term:

  * mms_full   — OP_MMS lanes, ln=L (round-1 anchor hunt shape)
  * mms_short  — OP_MMS lanes, ln=12 (post-seed-jump residue shape)
  * unc_only   — OP_UNC lanes (no LF loop; just the unc_sa walk)
  * none_op    — OP_NONE lanes (prep + fixed overheads only)
  * mext       — OP_MEXT lanes with curgap windows (EXT round shape)

Each is dispatched with the SAME (B, Lb) bank and the seed table the
driver uses, warm best-of-N.

Usage: python tools/probe_service_round.py [--genome 1000000]
           [--lanes 32768] [--read-len 80] [--repeat 5]
"""

from __future__ import annotations

import argparse
import functools
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from tools.bench_drivers import make_reads  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome", type=int, default=1_000_000)
    ap.add_argument("--lanes", type=int, default=32768)
    ap.add_argument("--read-len", type=int, default=80)
    ap.add_argument("--sa-rate", type=int, default=8)
    ap.add_argument("--seed-k", type=int, default=None)
    ap.add_argument("--repeat", type=int, default=5)
    args = ap.parse_args()

    import jax

    from bwt_tpu.utils import compile_cache

    compile_cache.enable()

    import jax.numpy as jnp

    import bwt_tpu
    from bwt_tpu.config import DEFAULT
    from bwt_tpu.models import batch_exec as bx
    from bwt_tpu.models.batch_exec import (
        OP_MEXT, OP_MMS, OP_NONE, OP_UNC, QueryService, _service_core,
    )

    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=args.genome).astype(np.uint8)
    print(f"building {args.genome}-base rate-{args.sa_rate} index on "
          f"{jax.devices()[0].platform}...", flush=True)
    fmi = bwt_tpu.build_index(codes, sa_sample_rate=args.sa_rate)
    np.asarray(fmi.C)

    svc = QueryService(fmi, codes, DEFAULT)
    reads = make_reads(codes, args.lanes, args.read_len, rng)
    svc.add_reads_batch([np.asarray(r, np.uint8) for r in reads],
                        with_revcomp=True)
    bank = svc.bank
    seed = svc.seed
    seed_k = args.seed_k if args.seed_k is not None else \
        (seed.k if seed is not None else 0)
    seed_rows = seed.rows if (seed is not None and seed_k) else None
    B = args.lanes
    Lb = int(bank.shape[1])
    print(f"bank ({bank.shape[0]}, {Lb}), seed_k={seed_k}", flush=True)

    rows = jnp.arange(B, dtype=jnp.int32) * 2
    zeros = jnp.zeros((B,), jnp.int32)

    @functools.partial(jax.jit, static_argnames=("sk",))
    def round_seeded(opc, ln, sp, ep, srows, sk):
        return _service_core(
            fmi, bank, opc, rows, zeros, ln, sp, ep, zeros,
            resolve=False, ext=True, with_crank=False,
            seed_rows=srows, seed_k=sk,
        )[:8]

    def round_(opc, ln, sp, ep, sk):
        if sk:
            return round_seeded(opc, ln, sp, ep, seed_rows, sk)
        return round_seeded(opc, ln, sp, ep, None, 0)

    def bench(name, opc_v, ln_v, sp_v=0, ep_v=0, sk=0):
        opc = jnp.full((B,), opc_v, jnp.int32)
        ln = jnp.full((B,), ln_v, jnp.int32)
        sp = jnp.full((B,), sp_v, jnp.int32)
        ep = jnp.full((B,), ep_v, jnp.int32)
        out = round_(opc, ln, sp, ep, sk)
        np.asarray(out[0])
        best = None
        for _ in range(args.repeat):
            t0 = time.perf_counter()
            out = round_(opc, ln, sp, ep, sk)
            np.asarray(out[0])
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        print(f"{name:28s} {best*1e3:8.2f} ms", flush=True)
        return best

    L = args.read_len
    bench("none_op (prep+walk only)", OP_NONE, 0)
    bench("unc_only", OP_UNC, 0)
    bench(f"mms ln={L} seed_k=0", OP_MMS, L, sk=0)
    if seed_rows is not None:
        bench(f"mms ln={L} seed_k={seed_k}", OP_MMS, L, sk=seed_k)
        bench(f"mms ln=24 seed_k={seed_k}", OP_MMS, 24, sk=seed_k)
    bench("mms ln=12 seed_k=0", OP_MMS, 12, sk=0)
    bench("mext ln=20 g=3", OP_MEXT, 20, sp_v=500_000, ep_v=3)


if __name__ == "__main__":
    main()
