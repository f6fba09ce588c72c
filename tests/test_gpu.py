"""Device == host on the GPU: the build, search and the phase-B DP
step compiled for the card give the CPU backend's results bit for bit.
Marked ``gpu``; skips where JAX has no GPU (README: how to run)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bwt_tpu
from bwt_tpu.ops import search

pytestmark = pytest.mark.gpu


def _on_cpu(fn, *args):
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        return jax.device_get(fn(*jax.device_put(args, cpu)))


def test_build_and_locate_gpu_equal_cpu(gpu, rng):
    codes = rng.integers(0, 4, size=200_000).astype(np.uint8)
    starts = rng.integers(0, len(codes) - 30, size=4096)
    pats = codes[np.add.outer(starts, np.arange(30))].astype(np.int32)
    lens = np.full((4096,), 30, np.int32)

    def run(c, p, l):
        fmi = bwt_tpu.build_index(np.asarray(c), sa_sample_rate=4)
        return fmi, search.locate(fmi, p, l)

    fmi_g, pos_g = jax.device_get(run(codes, pats, lens))
    fmi_c, pos_c = _on_cpu(run, codes, pats, lens)
    for name in ("bwt_words", "buckets", "sa_samples", "isa_samples", "C"):
        assert np.array_equal(getattr(fmi_g, name), getattr(fmi_c, name)), name
    assert np.array_equal(pos_g, pos_c)
    assert (pos_g == starts).mean() > 0.99  # random 30-mers are unique


def test_dp_step_gpu_equals_cpu(gpu, rng):
    """Phase B's DP step at its 48x64 bucket shape, 4096 jobs."""
    from bwt_tpu.models.batch_exec import _dp_step

    J, L1, L2 = 4096, 48, 64
    bank = rng.integers(0, 4, size=(512, 80)).astype(np.int32)
    genome = rng.integers(0, 4, size=100_000).astype(np.int32)
    args = (
        bank, genome,
        rng.integers(0, 512, size=J).astype(np.int32),          # row
        rng.integers(0, 32, size=J).astype(np.int32),           # roff
        rng.integers(1, L1 + 1, size=J).astype(np.int32),       # rlen
        rng.integers(0, 2, size=J).astype(np.int32),            # rrev
        rng.integers(0, 100_000 - L2, size=J).astype(np.int32), # gstart
        rng.integers(1, L2 + 1, size=J).astype(np.int32),       # glen
        rng.integers(0, 2, size=J).astype(np.int32),            # grev
        rng.integers(0, 2, size=J).astype(np.int32),            # want_nw
    )

    def run(*a):
        return _dp_step(*a, L1=L1, L2=L2)

    got = jax.device_get(run(*(jnp.asarray(x) for x in args)))
    want = _on_cpu(run, *args)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
