"""chip_smoke.py's independent checkers, on a 20 kb genome, and its
refusal to run without a GPU; the CPU-side choices the GPU port made
(platform-free seed depth, one executor cohort, ``--platform gpu``, the
compile-cache location)."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import bwt_tpu
import chip_smoke
from bwt_tpu.ops import search
from bwt_tpu.utils import compile_cache
from bwt_tpu.utils.cigar import Cigar

ROOT = pathlib.Path(chip_smoke.__file__).resolve().parent


@pytest.fixture(scope="module")
def small(rng):
    genome = np.random.default_rng(7).integers(0, 4, size=20_000,
                                               dtype=np.uint8)
    return genome, bwt_tpu.build_index(genome)


def test_kmer_histogram_matches_reverse_search(small):
    genome, fmi = small
    rng = np.random.default_rng(1)
    pats = np.concatenate([
        rng.integers(0, 4, size=(3000, 12)).astype(np.uint8),  # mostly absent
        chip_smoke.substrings(genome, 1000, 12, rng),          # present
    ])
    want = chip_smoke.expected_reverse_search(genome, pats)
    assert {0, 1, 2} <= set(want.tolist())  # all three outcomes occur
    got = search.reverse_search(fmi, pats.astype(np.int32),
                                np.full((len(pats),), 12, np.int32))
    assert np.array_equal(np.asarray(got), want)


def test_occurrence_check(small):
    genome, fmi = small
    rng = np.random.default_rng(2)
    pats = chip_smoke.substrings(genome, 500, 30, rng)
    pos = np.asarray(search.locate(fmi, pats.astype(np.int32),
                                   np.full((500,), 30, np.int32)))
    assert chip_smoke.occurs_at(genome, pats, pos).all()
    bad = pos.copy()
    bad[0] = (bad[0] + 1) % (len(genome) - 30)
    bad[1] = -1
    ok = chip_smoke.occurs_at(genome, pats, bad)
    assert not ok[0] and not ok[1] and ok[2:].all()


def test_cigar_query_length(small):
    from bwt_tpu.models import aligner

    genome, fmi = small
    c = Cigar()
    for op, n in (("M", 30), ("I", 2), ("D", 5), ("M", 48)):
        c.push(op, n)
    assert chip_smoke.cigar_query_len(c) == 80
    reads = chip_smoke.mutated_reads(genome, 32, 80, np.random.default_rng(3))
    fmi4 = bwt_tpu.build_index(genome, sa_sample_rate=4)
    res = [c for p, c in aligner.align_reads(fmi4, genome, reads) if p]
    assert res and all(chip_smoke.cigar_query_len(c) == 80 for c in res)


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
        text=True, env=env, cwd=ROOT, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_seed_depth_and_cohort_streams_are_platform_free(small):
    import inspect

    from bwt_tpu.models.batch_exec import (
        BatchExecutor, QueryService, seed_depth)

    assert QueryService(small[1]).seed.k == 6  # index on the CPU backend

    assert seed_depth(12, "cpu") == 6
    assert seed_depth(12, "gpu") == 12
    assert seed_depth(4, "cpu") == 4
    # one cohort on every platform: the executor has no cohort knob
    assert list(inspect.signature(BatchExecutor.run).parameters) == [
        "self", "gens"]


def test_platform_gpu_parses():
    from bwt_tpu import cli

    p = cli.build_parser()
    assert p.parse_args(["--platform", "gpu", "bwt", "x"]).platform == "gpu"
    assert p.parse_args(["bwt", "x"]).platform == "auto"
    (platform,) = [a for a in p._actions if a.dest == "platform"]
    assert platform.choices == ["auto", "cpu", "gpu"]
    with pytest.raises(SystemExit):
        p.parse_args(["--platform", "rocm", "bwt", "x"])


def test_compile_cache_dir(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir("gpu") == tmp_path
    assert compile_cache.cache_dir("cpu") == tmp_path
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    assert compile_cache.cache_dir("gpu") == ROOT / ".jax_cache"
    cpu = compile_cache.cache_dir("cpu")
    assert cpu.parent == ROOT and cpu.name.startswith(".jax_cache_cpu-")
    assert compile_cache.cache_dir("cpu") == cpu  # fixed, not per process


def test_compile_cache_off_outside_checkout(monkeypatch, tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.checkout() == ROOT
    monkeypatch.setattr(compile_cache, "checkout", lambda: None)
    assert compile_cache.cache_dir("gpu") is None
    assert compile_cache.enable("cpu") is None
    blocker = tmp_path / "file"
    blocker.write_text("")
    monkeypatch.setattr(compile_cache, "checkout", lambda: blocker)
    assert compile_cache.enable("gpu") is None  # mkdir fails: cache off
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir("cpu") == tmp_path


def test_dp_bucket_histogram_records_phase_b(small):
    """tools/ab_dp_fill.py's recorder sees every fused phase-B DP
    dispatch and leaves the alignments unchanged."""
    from bwt_tpu.models import aligner
    from tools import ab_dp_fill

    genome = small[0]
    fmi4 = bwt_tpu.build_index(genome, sa_sample_rate=4)
    reads = chip_smoke.mutated_reads(genome, 64, 80, np.random.default_rng(5))
    want = aligner.format_ref_output(aligner.align_reads(fmi4, genome, reads))
    res, seen = ab_dp_fill.record_buckets(
        aligner, lambda: aligner.align_reads(fmi4, genome, reads))
    assert aligner.format_ref_output(res) == want
    assert aligner._dp_scatter_bucket.__name__ == "_dp_scatter_bucket"
    assert seen and all(0 < jobs <= J for _, _, J, jobs in seen)
    hist = ab_dp_fill.histogram(seen)
    assert sum(c for c, _ in hist.values()) == len(seen)
    assert sum(j for _, j in hist.values()) == sum(s[3] for s in seen)
