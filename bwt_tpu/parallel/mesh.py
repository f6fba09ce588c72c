"""Multi-chip / multi-host scaling over a `jax.sharding.Mesh`.

The reference's only parallelism is 4 pthreads over shared memory
(histsortcomp.c:113-155, fmitest.c:54-91).  The multi-device design
(SURVEY.md section 2's parallelism table):

* **dp** (data parallel) — read batches shard across chips; each chip
  runs the identical lockstep backward-search program on its shard.
  This is the production axis: the FM-index of a chromosome-scale
  genome is small (~37.5% of the text bytes, README.md:12-14) and
  replicates into every device's memory.
* **tp** (index/tensor parallel) — for genomes whose index exceeds a
  device's memory, the packed-BWT words, Occ checkpoints and sampled
  SA shard along the sequence dimension; rank gathers then resolve
  through collectives that XLA hands to NCCL (NVLink within a host).
* Hit lists merge by an all-gather of per-shard position arrays; with
  batch order preserved the merged output is bit-identical to the
  single-chip run (deterministic merge).

Multi-host: call `jax.distributed.initialize()` before building the
mesh; the same `NamedSharding`s then span hosts, with NCCL routing
collectives over NVLink within a host and the network between hosts.
Every GPU of a host reaches every other at the same rate, so the mesh
follows the algorithm alone and takes devices in order.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bwt_tpu.index import FMIndex
from bwt_tpu.ops import search


def init_distributed(**kwargs) -> None:
    """Multi-host initialization: call once per host process before
    building a mesh (wraps ``jax.distributed.initialize``; no-op if
    already initialized).  After this, ``jax.devices()`` spans the
    cluster and the same NamedShardings in this module place data
    across hosts.  Pass ``coordinator_address``, ``num_processes`` and
    ``process_id`` explicitly where no cluster manager sets them.

    Call this before running any JAX computation (device constants
    included) — a pre-initialized local backend cannot join a cluster;
    such a failure is re-raised, never swallowed
    (tests/test_parallel.py's two-process harness exercises the real
    multi-process path on CPU)."""
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError as e:
        if "already initialized" in str(e).lower():
            return
        raise


def make_mesh(n_devices: int | None = None, *, tp: int = 1, axis_names=("dp", "tp")) -> Mesh:
    """Mesh over the first ``n_devices`` devices, shaped (dp, tp)."""
    devs = jax.devices()
    n = len(devs) if n_devices is None else n_devices
    if n % tp:
        raise ValueError(f"n_devices={n} not divisible by tp={tp}")
    arr = np.array(devs[:n]).reshape(n // tp, tp)
    return Mesh(arr, axis_names)


def _index_specs(sharded: bool) -> FMIndex:
    """PartitionSpec pytree matching FMIndex's data fields."""
    if sharded:
        return dict(
            bwt_words=P("tp"),
            buckets=P("tp", None),
            sa_samples=P("tp"),
            C=P(),
            endloc=P(),
        )
    return dict(bwt_words=P(), buckets=P(), sa_samples=P(), C=P(), endloc=P())


def _place_index(fmi: FMIndex, mesh: Mesh, specs) -> FMIndex:
    return FMIndex(
        bwt_words=jax.device_put(fmi.bwt_words, NamedSharding(mesh, specs["bwt_words"])),
        buckets=jax.device_put(fmi.buckets, NamedSharding(mesh, specs["buckets"])),
        sa_samples=jax.device_put(fmi.sa_samples, NamedSharding(mesh, specs["sa_samples"])),
        C=jax.device_put(fmi.C, NamedSharding(mesh, specs["C"])),
        endloc=jax.device_put(fmi.endloc, NamedSharding(mesh, specs["endloc"])),
        length=fmi.length,
        sa_rate=fmi.sa_rate,
        isa_samples=(
            None if fmi.isa_samples is None
            else jax.device_put(
                fmi.isa_samples, NamedSharding(mesh, specs["sa_samples"])
            )
        ),
    )


def replicate_index(fmi: FMIndex, mesh: Mesh) -> FMIndex:
    """Replicate the index into every device's HBM (the fast path)."""
    return _place_index(fmi, mesh, _index_specs(sharded=False))


def shard_index(fmi: FMIndex, mesh: Mesh) -> FMIndex:
    """Shard the index arrays along the sequence dimension over 'tp'
    (for indexes larger than one chip's HBM).  Leading dimensions are
    zero-padded up to the tp size; the padding rows sit past every
    reachable gather index (word <= nwords, sample <= length/32)."""
    tp = mesh.shape["tp"]

    def pad(x):
        n = x.shape[0]
        extra = (-n) % tp
        if extra:
            x = jnp.concatenate(
                [x, jnp.zeros((extra,) + x.shape[1:], x.dtype)]
            )
        return x

    fmi = FMIndex(
        bwt_words=pad(fmi.bwt_words),
        buckets=pad(fmi.buckets),
        sa_samples=pad(fmi.sa_samples),
        C=fmi.C,
        endloc=fmi.endloc,
        length=fmi.length,
        sa_rate=fmi.sa_rate,
        isa_samples=(
            None if fmi.isa_samples is None else pad(fmi.isa_samples)
        ),
    )
    return _place_index(fmi, mesh, _index_specs(sharded=True))


def shard_patterns(patterns, lengths, mesh: Mesh):
    """Shard a read batch across 'dp' (batch must divide dp size)."""
    ps = NamedSharding(mesh, P("dp", None))
    ls = NamedSharding(mesh, P("dp"))
    return (
        jax.device_put(jnp.asarray(patterns, jnp.int32), ps),
        jax.device_put(jnp.asarray(lengths, jnp.int32), ls),
    )


def sharded_search_step(fmi: FMIndex, patterns, lengths, mesh: Mesh):
    """One full data-parallel search step under the mesh: lockstep
    backward search + LF-walk locate of every read, plus the
    cross-shard total of matched reads (a psum-style reduction XLA
    lowers onto NCCL).  Returns (positions, match_counts, total_hits);
    positions/counts keep the global batch order (deterministic
    merge).
    """
    @jax.jit
    def step(fmi, patterns, lengths):
        r = search.backward_search(fmi, patterns, lengths)
        emptied_early = (~r["alive"]) & (r["nmatched"] <= lengths - 2)
        pos = search.unc_sa(fmi, r["start"])
        pos = jnp.where(emptied_early, -1, pos)
        counts = jnp.where(r["alive"], r["end"] - r["start"], 0)
        total = jnp.sum((pos >= 0).astype(jnp.int32))
        return pos, counts, total

    with mesh:
        return step(fmi, patterns, lengths)


def _shard_map(fn, mesh, in_specs, out_specs, check=True):
    try:
        from jax import shard_map
    except ImportError:  # older JAX
        from jax.experimental.shard_map import shard_map
    kw = {}
    if not check:
        # the replication checker can't infer that a tiled all_gather
        # output is replicated; the kwarg name varies across versions
        import inspect

        params = inspect.signature(shard_map).parameters
        kw = (
            {"check_vma": False} if "check_vma" in params
            else {"check_rep": False}
        )
    return shard_map(
        fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs, **kw
    )


def host_fetch(arrays) -> list[np.ndarray]:
    """Device->host fetch of a list of arrays that also works under
    multi-process ``jax.distributed``: fully-addressable arrays fetch
    directly (one parallel ``device_get``), globally-sharded ones
    all-gather their process-local shards so EVERY process holds the
    full value — the mesh drivers' host-side phases (stitch-log
    assemble, result packing) then run identically on every process,
    keeping N-process output byte-identical to 1-process."""
    arrays = list(arrays)
    if all(
        getattr(x, "is_fully_addressable", True) for x in arrays
    ):
        return [np.asarray(x) for x in jax.device_get(arrays)]
    from jax.experimental import multihost_utils

    return [
        np.asarray(x)
        if getattr(x, "is_fully_addressable", True)
        else np.asarray(multihost_utils.process_allgather(x, tiled=True))
        for x in arrays
    ]


def gather_hits(positions, mesh: Mesh | None = None) -> np.ndarray:
    """Merge the sharded hit list into the global batch order.

    With a mesh, the merge is an **explicit tiled all_gather over the
    'dp' axis** (an XLA collective that NCCL carries), after which every
    device holds the identical replicated array — the deterministic
    merge from the blueprint (SURVEY.md section 2's parallelism
    table): output order is the global batch order, independent of
    device order within the axis (tests/test_parallel.py pins this by
    reversing the mesh).  Without a mesh, falls back to the host
    device-get of the addressable shards.
    """
    if mesh is None:
        return np.asarray(positions)
    f = jax.jit(
        _shard_map(
            lambda x: jax.lax.all_gather(x, "dp", axis=0, tiled=True),
            mesh,
            in_specs=P("dp"),
            out_specs=P(),
            check=False,
        )
    )
    return np.asarray(f(positions))


# --------------------------------------------------------------------------
# Checkpoint-local tp-sharded search (explicit collectives)
# --------------------------------------------------------------------------
#
# ``shard_index`` + XLA auto-partitioning is correctness-only: XLA
# lowers each rank row-gather over a tp-sharded table however it likes
# (worst case an all-gather of the table per step).  The credible
# >HBM-genome design is gather-local + psum: every shard gathers the
# queried rows from its LOCAL bucket block (clipped, masked to rows it
# owns) and one (B, 8)-int psum over 'tp' reconstructs the true rows.
# Per rank that costs the same local-gather memory traffic as the
# replicated path plus one 32 B/query all-reduce over NVLink.  Its
# cost on four H100s is not measured yet (ROADMAP queue 1); the CPU
# mesh pins correctness and compile-ability only.
#
# The mechanism is ``FMIndex.tp_axis``: a static marker telling every
# gather primitive in ops/{rank,search} that the index leaves are this
# shard's LOCAL blocks (ops/rank._rows / take_sharded do the clipped
# local gather + psum).  The SAME traced programs — backward_search,
# unc_sa, isa_window, the fused _service_core, the driver automatons —
# therefore run unmodified over a tp-sharded index inside shard_map.


def tp_view(fmi_local: FMIndex, tp_axis: str = "tp") -> FMIndex:
    """Mark an index pytree as a per-shard tp view (see
    FMIndex.tp_axis).  Apply to a :func:`shard_index` result before
    passing it into a ``shard_map`` whose in_specs are
    :func:`fmi_spec_tree`; never query a tp view outside shard_map."""
    import dataclasses

    return dataclasses.replace(fmi_local, tp_axis=tp_axis)


def fmi_spec_tree(fmi: FMIndex) -> FMIndex:
    """A PartitionSpec pytree shaped like ``fmi`` for shard_map
    in_specs: tp-sharded leaf specs when ``fmi.tp_axis`` is set,
    replicated otherwise."""
    d = _index_specs(sharded=fmi.tp_axis is not None)
    return FMIndex(
        bwt_words=d["bwt_words"],
        buckets=d["buckets"],
        sa_samples=d["sa_samples"],
        C=d["C"],
        endloc=d["endloc"],
        length=fmi.length,
        sa_rate=fmi.sa_rate,
        isa_samples=None if fmi.isa_samples is None else d["sa_samples"],
        tp_axis=fmi.tp_axis,
    )


def tp_locate(fmi_sharded: FMIndex, patterns, lengths, mesh: Mesh):
    """Full locate (lockstep backward search + LF-walk, seqindex.c:
    228-277 semantics) over a tp-sharded index with explicit local
    gathers + psum collectives; reads shard over 'dp'.  Returns
    (positions, counts) in global batch order, bit-identical to the
    single-device :func:`bwt_tpu.ops.search.locate`.

    One shard_map over the generic tp-aware ops (the tp_axis plumbing
    above): inside, each shard holds a local block of the bucket /
    sample tables and the full read shard, and backward_search +
    unc_sa themselves issue the local gathers + psums."""
    from bwt_tpu.ops import search as search_ops

    fmi_tp = tp_view(fmi_sharded)

    def inner(fmi_loc, pats, lens):
        r = search_ops.backward_search(fmi_loc, pats, lens)
        emptied_early = (~r["alive"]) & (r["nmatched"] <= lens - 2)
        pos = search_ops.unc_sa(fmi_loc, r["start"])
        pos = jnp.where(emptied_early, -1, pos)
        counts = jnp.where(r["alive"], r["end"] - r["start"], 0)
        return pos, counts

    f = jax.jit(
        _shard_map(
            inner,
            mesh,
            in_specs=(fmi_spec_tree(fmi_tp), P("dp", None), P("dp")),
            out_specs=(P("dp"), P("dp")),
            check=False,
        )
    )
    return f(
        fmi_tp,
        jnp.asarray(patterns, jnp.int32),
        jnp.asarray(lengths, jnp.int32),
    )
