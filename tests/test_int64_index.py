"""The 64-bit-clean FMIndex slice (csacak.c:517's int32 TODO, done with
one row-gather per rank): `build_index(..., index_dtype=np.int64)` builds 12-int bucket
rows (occ split lo/hi so a rank is still one int32 row-gather) with
int64 C / endloc / SA / ISA samples, the SAME query programs serve it
(every op follows the array dtypes), and the npz format round-trips it
verbatim.

Runs in a SUBPROCESS with jax_enable_x64: the flag is process-global
and changes integer promotion for everything after it, so it must not
leak into the rest of the suite.
"""

import os
import subprocess
import sys

_SCRIPT = r"""
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np
import jax.numpy as jnp

import bwt_tpu
from bwt_tpu import io as bio
from bwt_tpu.ops import search

rng = np.random.default_rng(17)
codes = rng.integers(0, 4, size=5000).astype(np.uint8)

f32 = bwt_tpu.build_index(codes, sa_sample_rate=8)
f64 = bwt_tpu.build_index(codes, sa_sample_rate=8, index_dtype=np.int64)

# layout + dtypes
assert f64.buckets.shape[-1] == 12, f64.buckets.shape
for name in ("sa_samples", "isa_samples", "C", "endloc"):
    assert getattr(f64, name).dtype == jnp.int64, name
assert int(f64.endloc) == int(f32.endloc)
assert np.array_equal(np.asarray(f64.C), np.asarray(f32.C))
assert np.array_equal(np.asarray(f64.sa_samples), np.asarray(f32.sa_samples))

# query parity: backward_search / reverse_search / locate / mms,
# genome-sampled + mutated + N-bearing + absent patterns
B, L = 256, 24
pats = np.zeros((B, L), np.int32)
lens = np.zeros((B,), np.int32)
for b in range(B):
    plen = int(rng.integers(4, L + 1))
    j = int(rng.integers(0, len(codes) - plen))
    p = list(codes[j : j + plen])
    if rng.random() < 0.4:
        p[int(rng.integers(0, plen))] = int(rng.integers(0, 6))
    pats[b, :plen] = p
    lens[b] = plen
r32 = search.backward_search(f32, pats, lens)
r64 = search.backward_search(f64, pats, lens)
for k in ("start", "end", "sp", "ep", "nmatched", "alive"):
    assert np.array_equal(np.asarray(r32[k]), np.asarray(r64[k])), k
assert np.array_equal(
    np.asarray(search.locate(f32, pats, lens)),
    np.asarray(search.locate(f64, pats, lens)),
)
assert np.array_equal(
    np.asarray(search.reverse_search(f32, pats, lens)),
    np.asarray(search.reverse_search(f64, pats, lens)),
)
m32 = search.mms(f32, pats, lens)
m64 = search.mms(f64, pats, lens)
for a, b2 in zip(m32, m64):
    assert np.array_equal(np.asarray(a), np.asarray(b2))

# the full-SA recovery property: locate of every sampled origin
spots = rng.integers(0, len(codes) - 30, size=64)
sp = np.stack([codes[s : s + 30] for s in spots]).astype(np.int32)
sl = np.full((64,), 30, np.int32)
pos = np.asarray(search.locate(f64, sp, sl))
cnt = np.asarray(search.count_matches(f64, sp, sl))
for i, s in enumerate(spots):
    if cnt[i] == 1:
        assert pos[i] == s

# npz round-trip preserves the wide layout + answers
import tempfile, pathlib
tmp = pathlib.Path(tempfile.mkdtemp())
bio.write_npz_index(f64, tmp / "w.npz")
g = bio.read_npz_index(tmp / "w.npz")
assert g.buckets.shape[-1] == 12
assert g.sa_samples.dtype == jnp.int64 and g.C.dtype == jnp.int64
assert np.array_equal(
    np.asarray(search.locate(g, pats, lens)),
    np.asarray(search.locate(f64, pats, lens)),
)

# int32 refuses quietly-truncating paths
try:
    bwt_tpu.build_index(codes, sa=np.arange(len(codes) + 1),
                        index_dtype=np.int64)
    raise SystemExit("expected ValueError for sa= + int64")
except ValueError:
    pass

# the wide index also serves tp-sharded (>HBM) — local gathers + psum
# over 'tp' follow the dtypes like everything else
from bwt_tpu import parallel
if len(jax.devices()) >= 8:
    mesh = parallel.make_mesh(8, tp=2)
    p8 = np.tile(sp[:8], (1, 1))
    l8 = sl[:8]
    pshard, lshard = parallel.shard_patterns(sp[:8], sl[:8], mesh)
    pos_r, _, _ = parallel.sharded_search_step(
        parallel.replicate_index(f64, mesh), pshard, lshard, mesh)
    pos_s, _, _ = parallel.sharded_search_step(
        parallel.shard_index(f64, mesh), pshard, lshard, mesh)
    assert np.array_equal(np.asarray(pos_r), np.asarray(pos_s))
    assert np.array_equal(
        np.asarray(parallel.gather_hits(pos_r)),
        np.asarray(search.locate(f64, sp[:8], sl[:8])),
    )
    print("INT64 TP OK")
print("INT64 SLICE OK")
"""


def test_int64_index_end_to_end(tmp_path):
    script = tmp_path / "int64_drive.py"
    script.write_text(_SCRIPT)
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=8")
    res = subprocess.run(
        [sys.executable, str(script)], capture_output=True, text=True,
        env=env, timeout=600,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert "INT64 TP OK" in res.stdout
    assert "INT64 SLICE OK" in res.stdout
