"""Sharding tests on the 8-virtual-device CPU mesh (conftest sets
xla_force_host_platform_device_count=8)."""

import os
import pathlib

import numpy as np

import jax

import bwt_tpu
from bwt_tpu import codec, parallel
from bwt_tpu.ops import search

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _worker_env():
    """A bare environment for worker subprocesses that import this
    checkout's package; the compile-cache variable passes through."""
    keep = ("HOME", "TMPDIR", "JAX_COMPILATION_CACHE_DIR")
    return dict(
        {k: os.environ[k] for k in keep if k in os.environ},
        PATH="/usr/bin:/bin:/usr/local/bin", PYTHONPATH=str(ROOT),
    )


def _problem(batch):
    g = codec.random_genome(3000, seed=3)
    fmi = bwt_tpu.build_index(g)
    codes = codec.encode_genome(g)
    rng = np.random.default_rng(0)
    starts = rng.integers(0, 3000 - 20, size=batch)
    pats = np.stack([codes[s : s + 20] for s in starts]).astype(np.int32)
    lens = np.full((batch,), 20, np.int32)
    return fmi, pats, lens, starts


def test_replicated_dp_matches_single_device():
    assert len(jax.devices()) >= 8
    fmi, pats, lens, _ = _problem(64)
    want = np.asarray(search.locate(fmi, pats, lens))

    mesh = parallel.make_mesh(8, tp=1)
    fmi_r = parallel.replicate_index(fmi, mesh)
    p, l = parallel.shard_patterns(pats, lens, mesh)
    pos, counts, total = parallel.sharded_search_step(fmi_r, p, l, mesh)
    got = parallel.gather_hits(pos)
    assert np.array_equal(got, want)
    assert int(total) == int(np.sum(want >= 0))


def test_sharded_index_matches_replicated():
    fmi, pats, lens, _ = _problem(32)
    mesh = parallel.make_mesh(8, tp=4)
    p, l = parallel.shard_patterns(pats, lens, mesh)
    pos_r, _, _ = parallel.sharded_search_step(
        parallel.replicate_index(fmi, mesh), p, l, mesh
    )
    pos_s, _, _ = parallel.sharded_search_step(
        parallel.shard_index(fmi, mesh), p, l, mesh
    )
    assert np.array_equal(np.asarray(pos_r), np.asarray(pos_s))


def test_sharded_suffix_array_matches_single_device():
    """The sharded prefix-doubling build (sort state distributed over
    the mesh via merge-split sorts + ppermute shifts) must reproduce
    the single-device SA bit-exactly — including repetitive worst
    cases that run the doubling to full depth, non-multiple-of-shards
    lengths, and the tiny-input fallback."""
    from bwt_tpu.ops import suffix
    from bwt_tpu.parallel.suffix_dist import sharded_suffix_array

    mesh = parallel.make_mesh(8, tp=8)
    rng = np.random.default_rng(9)
    cases = [
        rng.integers(0, 4, size=5000).astype(np.uint8),
        rng.integers(0, 4, size=4097).astype(np.uint8),
        np.zeros(2048, np.uint8),  # max doubling depth
        np.tile(np.array([0, 1, 2, 3, 0, 1], np.uint8), 500),
        np.tile(np.array([0, 1], np.uint8), 600),
        rng.integers(0, 4, size=100).astype(np.uint8),  # fallback path
    ]
    for codes in cases:
        want = np.asarray(suffix.suffix_array(codes))
        got = sharded_suffix_array(codes, mesh, axis="tp")
        assert np.array_equal(want, got), len(codes)


def test_build_index_sharded_byte_parity(tmp_path):
    """An index built through the sharded sort must serialize
    byte-identically to the single-device build (and therefore to the
    C build_index, which the single-device path is pinned to)."""
    from bwt_tpu import io as bio
    from bwt_tpu.parallel.suffix_dist import build_index_sharded

    g = codec.random_genome(30000, seed=13)
    mesh = parallel.make_mesh(8, tp=8)
    fmi_s = build_index_sharded(g, mesh)
    bio.write_ref_index(fmi_s, tmp_path / "s.idx")
    bio.write_ref_index(bwt_tpu.build_index(g), tmp_path / "d.idx")
    assert (tmp_path / "s.idx").read_bytes() == (tmp_path / "d.idx").read_bytes()


def test_dp_driver_automatons_match_single_device():
    """The flagship drivers scale data-parallel: align_reads /
    rna_seq with mesh= run the device automaton under shard_map (lanes
    sharded over 'dp', index replicated, zero collectives) and must be
    bit-identical to the single-device device engine AND the host
    generator engine."""
    from bwt_tpu.models import aligner, rnaseq

    g = codec.random_genome(6000, seed=11)
    fmi = bwt_tpu.build_index(g, sa_sample_rate=8)
    codes = codec.encode_genome(g)
    rng = np.random.default_rng(5)
    mesh = parallel.make_mesh(8, tp=1)

    reads = []
    for _ in range(100):
        j = int(rng.integers(0, len(codes) - 80))
        r = codes[j : j + 80].copy()
        for _ in range(int(rng.integers(0, 3))):
            k = int(rng.integers(0, 80))
            r[k] = rng.integers(0, 6)  # incl. N: resolve=True under dp
        reads.append(r)
    single = aligner.align_reads(fmi, g, reads, engine="device",
                                 with_strand=True)
    meshed = aligner.align_reads(fmi, g, reads, engine="device",
                                 with_strand=True, mesh=mesh)
    for k, (h, d) in enumerate(zip(single, meshed)):
        assert h[0] == d[0] and h[2] == d[2], (k, h, d)
        assert (str(h[1]) == str(d[1])) if h[1] else d[1] is None, (k, h, d)

    rr = [r[:50] for r in reads]
    np.testing.assert_array_equal(
        rnaseq.rna_seq(fmi, rr, engine="device"),
        rnaseq.rna_seq(fmi, rr, engine="device", mesh=mesh),
    )

    # third driver: search_reads anchor scan (odd count -> pad path)
    from bwt_tpu.models import exact

    sr = [r[:60] for r in reads[:77]]
    single_sr = exact.search_reads(fmi, sr)
    meshed_sr = exact.search_reads(fmi, sr, mesh=mesh)
    for key in single_sr:
        np.testing.assert_array_equal(single_sr[key], meshed_sr[key])


def test_tp_sharded_driver_automatons_match_single_device():
    """The same three drivers over a tp-SHARDED index (the >HBM-genome
    serving path): with mesh=(dp, tp>1) the automatons' gathers resolve
    as local-block fetch + psum over 'tp' (FMIndex.tp_axis plumbing)
    and every output stays bit-identical to the single-device engine.
    N-bearing reads exercise the resolve path's interval-count psums."""
    from bwt_tpu.models import aligner, exact, rnaseq

    g = codec.random_genome(6000, seed=21)
    fmi = bwt_tpu.build_index(g, sa_sample_rate=8)
    codes = codec.encode_genome(g)
    rng = np.random.default_rng(9)

    reads = []
    for _ in range(40):
        j = int(rng.integers(0, len(codes) - 80))
        r = codes[j : j + 80].copy()
        for _ in range(int(rng.integers(0, 3))):
            k = int(rng.integers(0, 80))
            r[k] = rng.integers(0, 6)  # incl. N (code 5)
        reads.append(r)

    single = aligner.align_reads(fmi, g, reads, engine="device",
                                 with_strand=True)
    want_rna = rnaseq.rna_seq(fmi, [r[:50] for r in reads],
                              engine="device")
    sr = [r[:60] for r in reads[:37]]
    want_sr = exact.search_reads(fmi, sr)

    for tp in (2, 4):
        mesh = parallel.make_mesh(8, tp=tp)
        meshed = aligner.align_reads(fmi, g, reads, engine="device",
                                     with_strand=True, mesh=mesh)
        for k, (h, d) in enumerate(zip(single, meshed)):
            assert h[0] == d[0] and h[2] == d[2], (tp, k, h, d)
            assert (str(h[1]) == str(d[1])) if h[1] else d[1] is None

        np.testing.assert_array_equal(
            want_rna,
            rnaseq.rna_seq(fmi, [r[:50] for r in reads],
                           engine="device", mesh=mesh),
        )

        got_sr = exact.search_reads(fmi, sr, mesh=mesh)
        for key in want_sr:
            np.testing.assert_array_equal(want_sr[key], got_sr[key])


def test_tp_out_of_contract_garbage_parity(tmp_path):
    """Fuzz-found regression: a C-quirk lane whose mms interval lands
    PAST the SA range (osp > m) makes the service's unc_sa walk read
    sa_samples out of bounds — the replicated path's ``jnp.take``
    wraps negative indices and FILLS true out-of-range with the dtype
    minimum, and that garbage is pinned (host == single-device == the
    C oracle's own arithmetic).  The tp-sharded fetch must reproduce
    it exactly (wrap-then-fill emulation, ops/rank._rows /
    take_sharded); masking to zero rows diverged here.

    Runs in a SUBPROCESS: this workload's collective-heavy run leaves XLA:CPU state that can
    SIGSEGV a later unrelated jit at full-suite scale (CLAUDE.md's
    process-hazard notes)."""
    import subprocess
    import sys

    script = tmp_path / "tp_garbage_parity.py"
    script.write_text('''
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import bwt_tpu
from bwt_tpu import codec, parallel
from bwt_tpu.models import aligner

rng = np.random.default_rng(4005)
glen = int(rng.integers(3000, 12000))
g = codec.random_genome(glen, seed=int(rng.integers(1e6)))
fmi = bwt_tpu.build_index(g, sa_sample_rate=int(rng.choice([4, 8])))
codes = codec.encode_genome(g)
nreads = int(rng.integers(16, 64))
L = int(rng.integers(40, 100))
reads = []
for _ in range(nreads):
    j = int(rng.integers(0, glen - L))
    r = codes[j : j + L].copy()
    for _ in range(int(rng.integers(0, 5))):
        r[int(rng.integers(0, L))] = int(rng.integers(0, 6))
    reads.append(r)
host = aligner.align_reads(fmi, g, reads, engine="host", with_strand=True)
single = aligner.align_reads(fmi, g, reads, engine="device", with_strand=True)
mesh = parallel.make_mesh(8, tp=2)
meshed = aligner.align_reads(fmi, g, reads, engine="device",
                             with_strand=True, mesh=mesh)
for k, (h, a, b) in enumerate(zip(host, single, meshed)):
    assert h[0] == a[0] == b[0], (k, h, a, b)
    assert str(h[1]) == str(a[1]) == str(b[1]), (k, h, a, b)
    assert h[2] == a[2] == b[2], (k, h, a, b)
print("TP_GARBAGE_PARITY_OK")
''')
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run(
        [sys.executable, str(script)], capture_output=True, text=True,
        env=env, timeout=600,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert "TP_GARBAGE_PARITY_OK" in res.stdout


def test_two_process_mesh_drivers(tmp_path):
    """The mesh drivers run under real multi-process jax.distributed:
    two CPU processes x 4 virtual devices form one 8-device 'dp' mesh;
    align_reads / rna_seq / search_reads with mesh= must match the
    process-local single-device answers bit-exactly on BOTH processes
    (host_fetch all-gathers the dp-sharded outputs so every process
    assembles identical results)."""
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    script = tmp_path / "worker_drivers.py"
    script.write_text(
        '''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
pid = int(sys.argv[1]); port = sys.argv[2]
from bwt_tpu.utils import compile_cache
compile_cache.enable("cpu")
from bwt_tpu import parallel
parallel.init_distributed(
    coordinator_address="127.0.0.1:" + port, num_processes=2, process_id=pid)
assert jax.process_count() == 2 and len(jax.devices()) == 8
import numpy as np
import bwt_tpu
from bwt_tpu import codec
from bwt_tpu.models import aligner, exact, rnaseq
g = codec.random_genome(4000, seed=17)
fmi = bwt_tpu.build_index(g, sa_sample_rate=8)
codes = codec.encode_genome(g)
rng = np.random.default_rng(2)
reads = []
for _ in range(32):
    j = int(rng.integers(0, len(codes) - 70))
    r = codes[j : j + 70].copy()
    for _ in range(int(rng.integers(0, 3))):
        r[int(rng.integers(0, 70))] = rng.integers(0, 6)  # incl. N
    reads.append(r)
mesh = parallel.make_mesh(8, tp=1)

got = aligner.align_reads(fmi, g, reads, engine="device",
                          with_strand=True, mesh=mesh)
want = aligner.align_reads(fmi, g, reads, engine="host",
                           with_strand=True)
for k, (h, d) in enumerate(zip(want, got)):
    assert h[0] == d[0] and h[2] == d[2], (k, h, d)
    assert (str(h[1]) == str(d[1])) if h[1] else d[1] is None, (k, h, d)

rr = [r[:50] for r in reads]
np.testing.assert_array_equal(
    rnaseq.rna_seq(fmi, rr, engine="device", mesh=mesh),
    rnaseq.rna_seq(fmi, rr, engine="host"),
)

sr = [r[:60] for r in reads[:29]]  # odd count -> pad path
a = exact.search_reads(fmi, sr, mesh=mesh)
b = exact.search_reads(fmi, sr)
for key in b:
    np.testing.assert_array_equal(a[key], b[key])
print("WORKER_OK", pid)
'''
    )
    env = _worker_env()
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(i), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=480)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0 and "WORKER_OK" in out, (rc, out[-2000:], err[-3000:])


def test_two_process_tp_sharded_serving(tmp_path):
    """tp-sharded serving ACROSS process boundaries (VERDICT r4 #3):
    two CPU processes x 4 virtual devices form a (dp=2, tp=4) mesh
    whose tp groups each contain devices from BOTH processes (the
    device grid is transposed), so the FM-index shards live in
    different processes and every phase-A gather's psum crosses the
    process boundary.  All three drivers, N-bearing reads included,
    must match the process-local host-engine answers bit-exactly on
    both processes."""
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    script = tmp_path / "worker_tp.py"
    script.write_text(
        '''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
pid = int(sys.argv[1]); port = sys.argv[2]
from bwt_tpu.utils import compile_cache
compile_cache.enable("cpu")
from bwt_tpu import parallel
parallel.init_distributed(
    coordinator_address="127.0.0.1:" + port, num_processes=2, process_id=pid)
assert jax.process_count() == 2 and len(jax.devices()) == 8
import numpy as np
from jax.sharding import Mesh
import bwt_tpu
from bwt_tpu import codec
from bwt_tpu.models import aligner, exact, rnaseq

# transpose the device grid so every tp group spans both processes:
# rows (dp) = [d0 d2 d4 d6], [d1 d3 d5 d7] -- each holds two devices
# from process 0 and two from process 1
devs = np.array(jax.devices()).reshape(4, 2).T
mesh = Mesh(devs, ("dp", "tp"))
for row in devs:
    assert {d.process_index for d in row} == {0, 1}, devs

g = codec.random_genome(4000, seed=31)
fmi = bwt_tpu.build_index(g, sa_sample_rate=8)
codes = codec.encode_genome(g)
rng = np.random.default_rng(5)
reads = []
for _ in range(16):
    j = int(rng.integers(0, len(codes) - 70))
    r = codes[j : j + 70].copy()
    for _ in range(int(rng.integers(0, 3))):
        r[int(rng.integers(0, 70))] = rng.integers(0, 6)  # incl. N
    reads.append(r)

got = aligner.align_reads(fmi, g, reads, engine="device",
                          with_strand=True, mesh=mesh)
want = aligner.align_reads(fmi, g, reads, engine="host",
                           with_strand=True)
for k, (h, d) in enumerate(zip(want, got)):
    assert h[0] == d[0] and h[2] == d[2], (k, h, d)
    assert (str(h[1]) == str(d[1])) if h[1] else d[1] is None, (k, h, d)

rr = [r[:50] for r in reads]
np.testing.assert_array_equal(
    rnaseq.rna_seq(fmi, rr, engine="device", mesh=mesh),
    rnaseq.rna_seq(fmi, rr, engine="host"),
)

sr = [r[:60] for r in reads[:13]]  # odd count -> pad path
a = exact.search_reads(fmi, sr, mesh=mesh)
b = exact.search_reads(fmi, sr)
for key in b:
    np.testing.assert_array_equal(a[key], b[key])
print("WORKER_TP_OK", pid)
'''
    )
    env = _worker_env()
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(i), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=480)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0 and "WORKER_TP_OK" in out, (rc, out[-2000:], err[-3000:])


def test_graft_entry_single_and_multichip():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "__graft_entry__", ROOT / "__graft_entry__.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn, example_args = mod.entry()
    out = jax.jit(fn)(*example_args)
    assert np.asarray(out).shape == (64,)
    assert (np.asarray(out) >= 0).all()  # sampled substrings all locate
    mod.dryrun_multichip(8)
    mod.dryrun_multichip(4)


def test_tp_locate_matches_single_device():
    """The checkpoint-local (gather-local + psum) tp search path must be
    bit-identical to the single-device locate."""
    fmi, pats, lens, _ = _problem(32)
    want_pos = np.asarray(search.locate(fmi, pats, lens))
    want_cnt = np.asarray(search.count_matches(fmi, pats, lens))
    for tp in (2, 4, 8):
        mesh = parallel.make_mesh(8, tp=tp)
        fmi_s = parallel.shard_index(fmi, mesh)
        p, l = parallel.shard_patterns(pats, lens, mesh)
        pos, cnt = parallel.tp_locate(fmi_s, p, l, mesh)
        assert np.array_equal(np.asarray(pos), want_pos), tp
        assert np.array_equal(np.asarray(cnt), want_cnt), tp


def test_gather_hits_explicit_collective_and_determinism():
    """gather_hits with a mesh runs an explicit all_gather over 'dp';
    the merged bytes are identical regardless of device order."""
    fmi, pats, lens, _ = _problem(64)
    want = np.asarray(search.locate(fmi, pats, lens))

    mesh = parallel.make_mesh(8, tp=1)
    fmi_r = parallel.replicate_index(fmi, mesh)
    p, l = parallel.shard_patterns(pats, lens, mesh)
    pos, _, _ = parallel.sharded_search_step(fmi_r, p, l, mesh)
    got = parallel.gather_hits(pos, mesh)
    assert np.array_equal(got, want)

    # reversed device order: same global bytes
    from jax.sharding import Mesh
    rev_mesh = Mesh(np.array(jax.devices()[:8][::-1]).reshape(8, 1), ("dp", "tp"))
    fmi_r2 = parallel.replicate_index(fmi, rev_mesh)
    p2, l2 = parallel.shard_patterns(pats, lens, rev_mesh)
    pos2, _, _ = parallel.sharded_search_step(fmi_r2, p2, l2, rev_mesh)
    got2 = parallel.gather_hits(pos2, rev_mesh)
    assert got2.tobytes() == got.tobytes()


def test_two_process_distributed(tmp_path):
    """Real multi-process jax.distributed: two CPU processes, 4 virtual
    devices each, form one 8-device mesh; each shards its half of the
    read batch, runs the sharded search step, all-gathers, and checks
    the merged result against the expected single-process answer."""
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    script = tmp_path / "worker.py"
    script.write_text(
        '''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
pid = int(sys.argv[1]); port = sys.argv[2]
from bwt_tpu import parallel
parallel.init_distributed(
    coordinator_address="127.0.0.1:" + port, num_processes=2, process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8
import numpy as np
import bwt_tpu
from bwt_tpu import codec
from bwt_tpu.ops import search
g = codec.random_genome(3000, seed=3)
fmi = bwt_tpu.build_index(g)
codes = codec.encode_genome(g)
rng = np.random.default_rng(0)
starts = rng.integers(0, 3000 - 20, size=64)
pats = np.stack([codes[s : s + 20] for s in starts]).astype(np.int32)
lens = np.full((64,), 20, np.int32)
mesh = parallel.make_mesh(8, tp=1)
fmi_r = parallel.replicate_index(fmi, mesh)
from jax.sharding import NamedSharding, PartitionSpec as P
import jax.numpy as jnp
ps = NamedSharding(mesh, P("dp", None))
ls = NamedSharding(mesh, P("dp"))
pat_g = jax.make_array_from_process_local_data(ps, pats[pid * 32 : (pid + 1) * 32])
len_g = jax.make_array_from_process_local_data(ls, lens[pid * 32 : (pid + 1) * 32])
pos, counts, total = parallel.sharded_search_step(fmi_r, pat_g, len_g, mesh)
from jax.experimental import multihost_utils
merged = np.asarray(multihost_utils.process_allgather(pos, tiled=True))
want = starts.astype(np.int32)
assert np.array_equal(merged, want), (merged[:8], want[:8])
print("WORKER_OK", pid)
'''
    )
    env = _worker_env()
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(i), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0 and "WORKER_OK" in out, (rc, out[-2000:], err[-2000:])
