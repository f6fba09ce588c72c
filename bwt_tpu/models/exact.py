"""Batched exact anchored search — the search_reads.c model family.

``anchor_scan`` is the accelerator re-architecture of the per-read
anchor loop (search_reads.c:115-133): all reads advance in lockstep
through a jitted ``lax.while_loop``; each trip runs one batched MMS of
every read's current prefix and one batched locate, with per-read
``len`` registers and masking in place of the reference's sequential
control flow.

Semantics note: the reference main never converts read ASCII to 2-bit
codes before calling ``mms`` (search_reads.c:102-118 — unlike
single_align.c:450-474), so the shipped binary indexes ``fmi->C[]``
with ASCII values, reads out of bounds, and in practice anchors
nothing.  This module implements the *intended* semantics (reads
encoded like every other driver encodes them); byte parity with that
undefined behavior is neither possible nor meaningful.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from bwt_tpu import codec
from bwt_tpu.index import FMIndex
from bwt_tpu.ops import search

MIN_ANCHOR = 20  # search_reads.c:115,119
PAIR_WINDOW = 10000  # search_reads.c:154


@functools.partial(jax.jit, static_argnames=())
def _anchor_scan_impl(
    fmi: FMIndex,
    patterns: jax.Array,  # (B, L) int32
    lengths: jax.Array,  # (B,) int32
    min_anchor: jax.Array,  # () int32
):
    B, L = patterns.shape

    # Two per-trip paddings removed in round 5 (the search_reads rate
    # was the one driver still trailing the aligner at every scale):
    #   * only the LAST got anchor's position survives the loop, so
    #     the per-trip full-width ``unc_sa`` walks (~rate*ln(B) steps
    #     each — the dominant per-trip cost at rate 32) collapse to
    #     ONE deferred walk on the recorded interval starts;
    #   * finished lanes feed length-1 prefixes into the trip MMS and
    #     the MMS loop itself is dynamic, so a trip costs the live
    #     lanes' max remaining length, not the padded pattern width.
    # Per-lane step sequences for live lanes are unchanged — outputs
    # are bit-identical (test_anchor_scan_matches_host_loop).
    def cond(state):
        len_b, _, _ = state
        return jnp.any(len_b > min_anchor)

    def body(state):
        len_b, nmatch, anchor_sp = state
        active = len_b > min_anchor
        r = search.backward_search(
            fmi, patterns, jnp.where(active, len_b, 1),
            resolve_n=True, dynamic=True,
        )
        m = r["nmatched"] + r["skips"]
        got = active & (m >= min_anchor)
        anchor_sp = jnp.where(got, r["sp"], anchor_sp)
        nmatch = nmatch + got.astype(jnp.int32)
        len_b = jnp.where(
            active, jnp.where(got, len_b - m, len_b - 1), len_b
        )
        return len_b, nmatch, anchor_sp

    len_b, nmatch, anchor_sp = jax.lax.while_loop(
        cond,
        body,
        (
            jnp.asarray(lengths, jnp.int32),
            jnp.zeros((B,), jnp.int32),
            jnp.zeros((B,), fmi.C.dtype),  # sp dtype (int64-clean)
        ),
    )
    pos = jnp.where(nmatch > 0, search.unc_sa(fmi, anchor_sp), -1)
    return nmatch, pos


def anchor_scan(fmi: FMIndex, patterns, lengths, *, min_anchor: int = MIN_ANCHOR):
    """Lockstep anchor hunt.  Per read: repeatedly MMS the current
    prefix; an anchor of >= min_anchor consumes its length, anything
    else shrinks the prefix by one (search_reads.c:115-133).  Returns
    ``(n_anchors, last_anchor_pos)`` — position is the locate() of the
    most recent anchor, -1 if none (the reference leaves its
    ``forward_pos`` uninitialized in that case)."""
    return _anchor_scan_impl(
        fmi,
        jnp.asarray(patterns, jnp.int32),
        jnp.asarray(lengths, jnp.int32),
        jnp.asarray(min_anchor, jnp.int32),
    )


_ANCHOR_SCAN_MESH: dict = {}


def _anchor_scan_mesh_fn(mesh, fmi_r):
    """Jitted shard-mapped anchor scan, cached per (mesh, index meta) —
    rebuilding shard_map + jit per call would miss jit's
    function-identity cache and re-trace on every chunk.  The fmi
    in_spec comes from :func:`~bwt_tpu.parallel.mesh.fmi_spec_tree`, so
    the SAME wrapper serves both a replicated index (tp_axis None) and
    a tp-sharded view (gathers resolve local + psum over 'tp')."""
    key = (mesh, fmi_r.tp_axis, fmi_r.isa_samples is None,
           int(fmi_r.length), int(fmi_r.sa_rate))
    f = _ANCHOR_SCAN_MESH.get(key)
    if f is None:
        from jax.sharding import PartitionSpec as P

        from bwt_tpu.parallel.mesh import _shard_map, fmi_spec_tree

        f = jax.jit(_shard_map(
            _anchor_scan_impl,
            mesh,
            in_specs=(fmi_spec_tree(fmi_r), P("dp", None), P("dp"), P()),
            out_specs=P("dp"),
            check=False,
        ))
        _ANCHOR_SCAN_MESH[key] = f
    return f


def anchor_scan_mesh(mesh, fmi_r, patterns, lengths, *,
                     min_anchor: int = MIN_ANCHOR):
    """:func:`anchor_scan` under ``shard_map`` over the mesh's 'dp'
    axis: reads shard across chips, index gathers are local when the
    index is replicated, local-block + psum over 'tp' when ``fmi_r``
    is a tp view (>HBM indexes); each shard's lockstep while_loop
    exits when its own lanes finish.  Bit-identical to the
    single-device scan; B must divide the dp size (callers pad)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    dp = NamedSharding(mesh, P("dp"))
    return _anchor_scan_mesh_fn(mesh, fmi_r)(
        fmi_r,
        jax.device_put(jnp.asarray(patterns, jnp.int32),
                       NamedSharding(mesh, P("dp", None))),
        jax.device_put(jnp.asarray(lengths, jnp.int32), dp),
        jnp.asarray(min_anchor, jnp.int32),
    )


def _encode_batch(reads):
    # uniform-length string batches (the 1M-read serving workload)
    # encode as ONE joined buffer -> LUT -> reshape: ~10x the per-read
    # frombuffer loop (which costs ~10 s/M reads of pure Python
    # overhead at serving scale)
    B = len(reads)
    if B and isinstance(reads[0], str):
        L0 = len(reads[0])
        if all(type(r) is str and len(r) == L0 for r in reads):
            flat = codec.encode_read("".join(reads))
            return (
                flat.reshape(B, L0).astype(np.int32),
                np.full((B,), L0, np.int32),
            )
    arrs = [
        codec.encode_read(r) if isinstance(r, (str, bytes)) else np.asarray(r)
        for r in reads
    ]
    B = len(arrs)
    lens = np.fromiter((len(a) for a in arrs), np.int32, B)
    L = int(lens.max()) if B else 1
    # uniform-length batches (the 1M-read BASELINE workload) fill with
    # one stack instead of B row assignments (~3x host encode)
    if B and (lens == lens[0]).all():
        return np.stack(arrs).astype(np.int32, copy=False), lens
    pat = np.zeros((B, L), np.int32)
    for b, a in enumerate(arrs):
        pat[b, : len(a)] = a
    return pat, lens


def search_reads(
    fmi: FMIndex,
    reads,
    *,
    min_anchor: int | None = None,
    pair_window: int | None = None,
    config=None,
    mesh=None,
):
    """The search_reads pipeline: anchor-scan each read forward and
    PLAIN-REVERSED (reversed but *not* complemented — the reference's
    deliberate quirk, search_reads.c:112-114), then flag reads whose
    two direction positions fall within ``pair_window``
    (search_reads.c:154-159).

    Returns a dict of numpy arrays: ``fwd_matches, fwd_pos,
    rev_matches, rev_pos, paired``.

    ``mesh``: a `jax.sharding.Mesh` with a 'dp' axis shards each
    chunk's lanes across chips (:func:`anchor_scan_mesh`); outputs
    are bit-identical to the single-device run.
    """
    from bwt_tpu.config import DEFAULT

    cfg = config or DEFAULT
    min_anchor = cfg.min_anchor if min_anchor is None else min_anchor
    pair_window = cfg.pair_window if pair_window is None else pair_window
    pat, lens = _encode_batch(reads)
    if pat.shape[1] > cfg.max_read_len:
        raise ValueError(
            f"read length {pat.shape[1]} exceeds config.max_read_len "
            f"{cfg.max_read_len} (search_reads.c:30's 256*256 buffer)"
        )
    if pat.size and (lens == pat.shape[1]).all():
        # uniform-length batch: one vectorized flip, no per-read loop
        rev = np.ascontiguousarray(pat[:, ::-1])
    else:
        rev = np.zeros_like(pat)
        for b in range(pat.shape[0]):
            rev[b, : lens[b]] = pat[b, : lens[b]][::-1]
    # chunk the lockstep batch at config.search_batch reads per device
    # step (bounds per-dispatch HBM for very large read files)
    fmi_r = fmi
    if mesh is not None:
        from bwt_tpu.parallel.mesh import (
            replicate_index, shard_index, tp_view,
        )

        if mesh.shape.get("tp", 1) > 1:
            # sequence-sharded index for genomes past one chip's HBM:
            # the same automaton program, gathers local + psum per rank
            fmi_r = tp_view(shard_index(fmi, mesh))
        else:
            fmi_r = replicate_index(fmi, mesh)

    def scan(p, l):
        if mesh is None:
            return anchor_scan(fmi, p, l, min_anchor=min_anchor)
        ndp = mesh.shape["dp"]
        n = p.shape[0]
        padn = -n % ndp
        if padn:
            p = np.concatenate([p, np.zeros((padn, p.shape[1]), p.dtype)])
            l = np.concatenate([l, np.ones((padn,), l.dtype)])
        m, q = anchor_scan_mesh(mesh, fmi_r, p, l, min_anchor=min_anchor)
        return m[:n], q[:n]

    from bwt_tpu.parallel.mesh import host_fetch

    chunks = []
    for lo in range(0, pat.shape[0], cfg.search_batch):
        hi = lo + cfg.search_batch
        fm, fp = scan(pat[lo:hi], lens[lo:hi])
        bm, bp = scan(rev[lo:hi], lens[lo:hi])
        chunks.append(host_fetch((fm, fp, bm, bp)))
    if not chunks:
        z = np.zeros((0,), np.int32)
        fm, fp, bm, bp = z, z, z, z
    else:
        fm, fp, bm, bp = (
            np.concatenate([c[j] for c in chunks]) for j in range(4)
        )
    paired = (fm > 0) & (bm > 0) & (np.abs(fp - bp) < pair_window)
    return dict(
        fwd_matches=fm, fwd_pos=fp, rev_matches=bm, rev_pos=bp, paired=paired
    )


def format_ref_output(reads, result) -> str:
    """Render like the search_reads main loop (search_reads.c:100-161):
    header line, then a three-line block per paired read."""
    out = ["Beginning alignment\n"]
    for n, r in enumerate(reads):
        if result["paired"][n]:
            out.append(
                "\nRead %d: Aligned both forward (%d) and backward (%d)\n"
                % (n, result["fwd_matches"][n], result["rev_matches"][n])
            )
            out.append(
                "At locations %d and %d respectively\n"
                % (result["fwd_pos"][n], result["rev_pos"][n])
            )
            out.append(f"{r}\n" if isinstance(r, str) else codec.decode(r) + "\n")
    return "".join(out)
