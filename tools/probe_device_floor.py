"""Device-only floor of the aligner at 1 Mb / 131 k reads: dispatch
ALL chunks' automatons + phase-B device halves with ZERO host
assembly, sync once at the end.  The gap between this and the e2e
driver is host/latency overhead the pipeline fails to hide.

Usage: python tools/probe_device_floor.py
"""

import pathlib, sys, time, dataclasses
import numpy as np
_TOOLS = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(_TOOLS.parent))
import jax
from bwt_tpu.utils import compile_cache
compile_cache.enable()
import jax.numpy as jnp
import bwt_tpu
from bwt_tpu.config import DEFAULT
from bwt_tpu.models import aligner
from bwt_tpu.models.batch_exec import QueryService
sys.path.insert(0, str(_TOOLS))
from bench_drivers import make_reads

rng = np.random.default_rng(0)
codes = rng.integers(0, 4, size=1_000_000).astype(np.uint8)
fmi = bwt_tpu.build_index(codes, sa_sample_rate=4)
np.asarray(fmi.C)
genome_dev = jax.jit(lambda g: g.astype(jnp.int32))(jnp.asarray(codes))
reads = make_reads(codes, 131072, 80, rng)
cfg = dataclasses.replace(DEFAULT, search_batch=32768)
chunk = 32768
subs = [[np.asarray(r, np.uint8) for r in reads[i:i+chunk]]
        for i in range(0, len(reads), chunk)]

# warm all signatures once through the real driver
res = aligner.align_reads(fmi, codes, reads, config=cfg,
                          service=QueryService(fmi, genome_dev, cfg))

from bwt_tpu.models.aligner import (_align_chunk_dispatch,
                                    _assemble_dispatch, _PLAN_MEMO)
for rep in range(3):
    t0 = time.perf_counter()
    svcs, ctxs = [], []
    seed = QueryService(fmi, genome_dev, cfg).seed
    for sub in subs:
        svc = QueryService(fmi, genome_dev, cfg)
        out = _align_chunk_dispatch(fmi, len(codes), sub, cfg.anchor_len,
                                    False, svc, None, seed)
        key = (int(out[3].shape[0]), int(svc.bank.shape[1]))
        bctx = _assemble_dispatch(svc, len(sub), out,
                                  plan=_PLAN_MEMO.get(key))
        svcs.append(svc); ctxs.append(bctx)
    t_disp = time.perf_counter()
    # one sync on the last chunk's composed fetch
    jax.device_get(ctxs[-1][0][0][:1])
    t1 = time.perf_counter()
    print(f"rep {rep}: dispatch-all {t_disp-t0:.3f}s  device-drain "
          f"{t1-t_disp:.3f}s  total {t1-t0:.3f}s "
          f"({131072/(t1-t0):.0f} reads/s equivalent)")
