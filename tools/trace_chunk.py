"""Device-op time breakdown of one aligner chunk via the JAX profiler.

Captures an xplane trace around one warm 32 k-read chunk (automaton +
fused phase B) and prints the top device ops by self time, aggregated
by HLO category — separates the automaton's gathers, the Pallas DP
fill, the backtrack scans, the compose, and DMA.

Usage: python tools/trace_chunk.py [--genome 1000000] [--reads 32768]
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import pathlib
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from tools.bench_drivers import make_reads  # noqa: E402


def summarize(logdir: str, top: int = 25):
    """Parse the trace-viewer JSON gz produced by the plugin converter
    and aggregate device-track event self-times by name."""
    from tensorboard_plugin_profile.convert import raw_to_tool_data

    xs = glob.glob(f"{logdir}/**/*.xplane.pb", recursive=True)
    if not xs:
        print("no xplane captured", flush=True)
        return
    data, _ = raw_to_tool_data.xspace_to_tool_data(xs, "trace_viewer", {})
    tr = json.loads(data)
    events = tr["traceEvents"] if isinstance(tr, dict) else tr
    # device tracks: pid names containing "/device:"
    pids = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pids[e["pid"]] = e["args"].get("name", "")
    dev_pids = {p for p, nm in pids.items()
                if "Device" in nm or "device" in nm}
    tot = {}
    for e in events:
        if e.get("ph") == "X" and e.get("pid") in dev_pids:
            nm = e.get("name", "?")
            tot[nm] = tot.get(nm, 0.0) + e.get("dur", 0.0)
    rows = sorted(tot.items(), key=lambda kv: -kv[1])
    alltime = sum(tot.values())
    print(f"{'device op':60s} {'ms':>9s}  share")
    for nm, us in rows[:top]:
        print(f"{nm[:60]:60s} {us/1e3:9.2f}  {us/alltime:5.1%}")
    print(f"{'TOTAL (sum of op self times)':60s} {alltime/1e3:9.2f}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome", type=int, default=1_000_000)
    ap.add_argument("--reads", type=int, default=32768)
    ap.add_argument("--read-len", type=int, default=80)
    ap.add_argument("--sa-rate", type=int, default=8)
    ap.add_argument("--logdir", default=None)
    ap.add_argument("--top", type=int, default=30)
    args = ap.parse_args()

    import jax

    from bwt_tpu.utils import compile_cache

    compile_cache.enable()

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

    reads = make_reads(codes, args.reads, args.read_len, rng)
    codes_list = [np.asarray(r, np.uint8) for r in reads]

    def chunk():
        svc = QueryService(fmi, codes, DEFAULT)
        out = aligner._align_chunk_dispatch(
            fmi, np.int32(len(codes)), codes_list, DEFAULT.anchor_len,
            False, svc)
        return aligner._assemble_logs_fused(svc, len(codes_list), out)

    t0 = time.perf_counter()
    chunk()  # warm / compile
    print(f"warm chunk: {time.perf_counter()-t0:.2f}s", flush=True)

    logdir = args.logdir or tempfile.mkdtemp(prefix="bwttrace")
    t0 = time.perf_counter()
    with jax.profiler.trace(logdir):
        chunk()
    print(f"traced chunk: {time.perf_counter()-t0:.2f}s -> {logdir}",
          flush=True)
    summarize(logdir, args.top)


if __name__ == "__main__":
    main()
