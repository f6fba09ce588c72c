"""Multi-chip suffix-array construction: sharded prefix doubling.

Why: the single-chip build's limit is the SORT, not the index — the
doubling rounds keep ~40 B/base of sort workspace live (keys, shifted
keys, payload, ping-pong buffers), while the finished index is only
~0.9 B/base.  Sharding the *sort* across a mesh divides the workspace
per device by the shard count and lifts the build cap accordingly
(p devices -> ~p times one device's cap), with the final (small)
index arrays built anywhere.

How (everything inside ``shard_map`` over one mesh axis, all shapes
static, all communication explicit XLA collectives):

* ranks live in TEXT order, sharded contiguously (shard s owns global
  positions [s*nloc, (s+1)*nloc));
* the shift ``r2[i] = r[i+k]`` (single-device form: a dynamic_slice,
  ops/suffix.py:100-106) becomes two static ``ppermute`` block moves
  (shards s+k//nloc and s+k//nloc+1) + one static slice — k is a
  Python int per round, so the permutations are compile-time constants;
* the global 2-key sort is an **odd-even block merge-split sort**: one
  local ``lax.sort``, then p rounds of neighbor block exchange
  (ppermute) + 2*nloc-element local merge, keeping the lower/upper
  half — after p rounds the sharded array is globally sorted (the
  classic block transposition-sort bound);
* dense re-ranking is a distributed segmented scan: local cumsum of
  "key changed" flags (the cross-shard boundary flag arrives by a
  1-step ppermute) + exclusive shard offsets from an ``all_gather`` of
  shard sums;
* the scatter back to text order (``new_r[sa[i]] = rank_i``, a global
  random scatter) is re-expressed as a SECOND distributed sort keyed
  by ``sa`` — ``sa`` is a permutation of the global positions, so
  sorting (sa, rank) by sa is exactly the scatter, with static shapes
  and no per-destination capacity bounds (the all_to_all form would
  need data-dependent padding);
* padding positions (m..p*nloc) carry unique past-everything keys so
  they stay glued to the global tail and never tie (a shared pad key
  would keep the doubling loop alive forever).

Outputs are bit-identical to :func:`bwt_tpu.ops.suffix.suffix_array`
(suffixes of the sentinel-terminated string are unique, so every
correct algorithm yields the identical array); tests pin equality on
the 8-virtual-device CPU mesh including repetitive worst cases, and
index files built from either path are byte-identical.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from bwt_tpu.parallel.mesh import _shard_map

_INIT_K = 12  # matches ops/suffix._INIT_K


def _ax_index(ax):
    return jax.lax.axis_index(ax).astype(jnp.int32)


def _block_from(x, d: int, ax, p: int):
    """The block ``x`` of shard ``s + d`` (zeros where s + d >= p)."""
    if d == 0:
        return x
    if d >= p:
        return jnp.zeros_like(x)
    perm = [(s, s - d) for s in range(p) if 0 <= s - d]
    return jax.lax.ppermute(x, ax, perm)


def _blocks_from_pair(x, d: int, ax, p: int):
    """(block at s+d, block at s+d+1) as a CHAIN of two ppermutes —
    the second shifts the first's result by one, so the collectives
    are data-dependent (never concurrently in flight; see
    ops/rank.rows2 on XLA:CPU's same-channel rendezvous hazard)."""
    a = _block_from(x, d, ax, p)
    return a, _block_from(a, 1, ax, p)


def _merge_split_sort(arrs, num_keys: int, ax, p: int):
    """Distributed sort of the sharded-by-rows tuple ``arrs``: local
    sort, then p odd-even rounds of block exchange + merge.  Sorted
    globally across the shard order; within-shard shapes unchanged."""
    nloc = arrs[0].shape[0]
    arrs = jax.lax.sort(arrs, num_keys=num_keys)
    me = _ax_index(ax)
    for t in range(p):
        # even rounds pair (0,1)(2,3)...; odd rounds pair (1,2)(3,4)...
        base = t & 1
        pairs = [(s, s + 1) for s in range(base, p - 1, 2)]
        if not pairs:
            continue
        lo = {a for a, _ in pairs}
        hi = {b for _, b in pairs}
        perm = [(a, b) for a, b in pairs] + [(b, a) for a, b in pairs]
        partnered = jnp.asarray(
            [s in lo or s in hi for s in range(p)]
        )[me]
        is_lo = jnp.asarray([s in lo for s in range(p)])[me]
        # ONE ppermute for all arrays (stacked): independent
        # collectives can execute concurrently on XLA:CPU and collide
        # in the same-channel rendezvous (ops/rank.rows2) — and one
        # wider permute is cheaper than three anyway
        theirs = tuple(jax.lax.ppermute(jnp.stack(arrs), ax, perm))
        # order the 2-block concat as [lower shard | upper shard]
        cat = tuple(
            jnp.where(
                is_lo,
                jnp.concatenate([a, b]),
                jnp.concatenate([b, a]),
            )
            for a, b in zip(arrs, theirs)
        )
        merged = jax.lax.sort(cat, num_keys=num_keys)
        keep = tuple(
            jnp.where(is_lo, x[:nloc], x[nloc:]) for x in merged
        )
        arrs = tuple(
            jnp.where(partnered, k, a) for k, a in zip(keep, arrs)
        )
    return arrs


@functools.lru_cache(maxsize=128)
def _make_round(mesh, ax, p: int, nloc: int, m: int, k: int):
    """One doubling round (static k): returns (new_r, sa, ranks, done)."""
    m_pad = p * nloc
    d, off = k // nloc, k % nloc

    def inner(r):
        me = _ax_index(ax)
        lo = me * nloc
        j = lo + jnp.arange(nloc, dtype=jnp.int32)  # global positions
        # --- r2 = r[j + k], -1 past the true end (ops/suffix.py:100)
        a, b = _blocks_from_pair(r, d, ax, p)
        r2 = jax.lax.dynamic_slice(
            jnp.concatenate([a, b]), (off,), (nloc,)
        )
        r2 = jnp.where(j + k < m, r2, -1)
        # --- global 2-key sort of (r, r2, j)
        kr, kr2, sa = _merge_split_sort((r, r2, j), 2, ax, p)
        # --- dense ranks: segmented scan over "key changed" flags
        prev = jax.lax.ppermute(
            jnp.stack([kr[-1:], kr2[-1:]]), ax,
            [(s, s + 1) for s in range(p - 1)]
        )  # one permute for both boundary keys
        pk = jnp.concatenate([prev[0], kr[:-1]])
        pk2 = jnp.concatenate([prev[1], kr2[:-1]])
        changed = ((kr != pk) | (kr2 != pk2)).astype(jnp.int32)
        changed = jnp.where((me == 0) & (jnp.arange(nloc) == 0), 0, changed)
        local = jnp.cumsum(changed)
        # one all_gather carries the shard's scan total AND the
        # changed-count (they were two independent collectives)
        g = jax.lax.all_gather(
            jnp.stack([local[-1], jnp.sum(changed)]), ax
        )  # (p, 2)
        offset = jnp.sum(jnp.where(jnp.arange(p) < me, g[:, 0], 0))
        ranks = local + offset
        done = (jnp.sum(g[:, 1]) + 1) == m_pad
        # --- scatter ranks to text order == sort (sa, ranks) by sa
        _, new_r = _merge_split_sort((sa, ranks), 1, ax, p)
        return new_r, sa, ranks, done

    f = _shard_map(
        inner, mesh, in_specs=P(ax),
        out_specs=(P(ax), P(ax), P(ax), P()), check=False,
    )
    return jax.jit(f)


@functools.lru_cache(maxsize=64)
def _make_init(mesh, ax, p: int, nloc: int, m: int):
    """Initial ranks: the 12-character packed-prefix keys of
    ops/suffix._initial_ranks, computed shard-locally with a 12-char
    halo from the next shard; identical key ORDER (the values differ
    by a constant +1 offset scheme but order is what doubling uses).
    Pads get unique past-everything keys."""
    length = m - 1
    m_pad = p * nloc

    def inner(codes):
        me = _ax_index(ax)
        lo = me * nloc
        j = lo + jnp.arange(nloc, dtype=jnp.int32)
        halo = _block_from(codes, 1, ax, p)[:_INIT_K]
        ext = jnp.concatenate([codes, halo, jnp.zeros_like(halo)])
        # vals[i] = sum_t codes[i+t] * 4^(11-t), zeros past the end
        vals = jnp.zeros((nloc,), jnp.int32)
        for t in range(_INIT_K):
            c = jax.lax.dynamic_slice(ext, (t,), (nloc,))
            c = jnp.where(j + t < length, c, 0)
            vals = vals * 4 + c
        tie = _INIT_K - jnp.clip(j - (length - _INIT_K), 0, _INIT_K)
        keys = vals * 13 + tie + 1
        keys = jnp.where(j == length, 0, keys)  # sentinel first
        big = jnp.int32(2147400000)
        keys = jnp.where(j > length, big - m_pad + j, keys)  # unique pads
        return keys

    f = _shard_map(inner, mesh, in_specs=P(ax), out_specs=P(ax),
                   check=False)
    return jax.jit(f)


def sharded_suffix_array(codes, mesh, *, axis: str = "tp") -> np.ndarray:
    """Suffix array of ``codes + sentinel`` built with the sort state
    sharded over ``mesh``'s ``axis`` (see module docstring).  Returns
    the host array, bit-identical to
    :func:`bwt_tpu.ops.suffix.suffix_array`."""
    from bwt_tpu.ops import suffix as _suffix

    codes = np.asarray(codes)
    n = int(codes.shape[0])
    m = n + 1
    p = int(mesh.shape[axis])
    if p == 1 or m < 4 * p * _INIT_K:
        return np.asarray(_suffix.suffix_array(codes))
    nloc = -(-m // p)
    m_pad = p * nloc
    cpad = np.zeros(m_pad, np.int32)
    cpad[:n] = codes
    spec = NamedSharding(mesh, P(axis))
    cdev = jax.device_put(jnp.asarray(cpad), spec)
    r = _make_init(mesh, axis, p, nloc, m)(cdev)
    k = _INIT_K
    sa = None
    while k < m:
        r, sa, _, done = _make_round(mesh, axis, p, nloc, m, k)(r)
        if bool(np.asarray(done)):
            break
        k *= 2
    return np.asarray(sa)[:m]


def build_index_sharded(codes, mesh, *, axis: str = "tp", **kwargs):
    """Chromosome-and-beyond index build: the suffix sort (the memory
    hog, ~40 B/base of workspace) runs sharded over the mesh; the
    finished index arrays (~0.9 B/base) are then built single-device
    from the SA.  Byte-identical output to
    :func:`bwt_tpu.build_index` (tests pin the serialized file)."""
    import bwt_tpu
    from bwt_tpu import codec

    if isinstance(codes, (str, bytes)):
        codes = codec.encode_genome(codes)
    sa = sharded_suffix_array(codes, mesh, axis=axis)
    return bwt_tpu.build_index(codes, sa=sa, **kwargs)
