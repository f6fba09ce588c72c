"""Occ/rank queries over a fused checkpoint+payload bucket layout.

The reference answers rank() with a checkpoint array read plus a
byte-table loop (seqindex.c:91-113).  An accelerator answers it with
gathers from device memory, and random-index gathers dominate the whole engine's cost —
so the layout is built around *one row-gather per query*:

    bucket row (32 B, aligned):  [occ_A occ_C occ_G occ_T | w0 w1 w2 w3]

where ``occ_c`` counts symbol ``c`` in ``bwt[0 : 64b]`` and ``w0..w3``
are the next 64 bases, 16 little-endian 2-bit lanes per uint32 word.
A rank (or an LF step, which also needs the BWT character) touches
exactly one row; the in-bucket count is a register-only
XOR/mask/popcount over the four payload words (replacing the
reference's 1 KiB lookup table, seqindex.c:115-138).  Semantics are
bit-exact with seqindex.c:214-225 including sentinel skipping.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

import numpy as np

# numpy scalars, NOT jnp: a module-level jnp constant would initialize
# the JAX backend at import time, breaking jax.distributed.initialize
# for any process that imports bwt_tpu before calling it
_LANES = np.uint32(0x55555555)
_FULL = np.uint32(0xFFFFFFFF)

BUCKET_WORDS = 4           # payload words per bucket
BUCKET_BASES = 64          # bases per bucket
ROW_INTS = 4 + BUCKET_WORDS
# 64-bit-clean layout (genomes past the int32 cap, csacak.c:517's TODO):
# occ checkpoints split into (lo, hi) int32 halves so a row is still ONE
# int32 gather — [occ_lo(4) | occ_hi(4) | words(4)], 48 B.  Every query
# helper below dispatches on the row width (static under jit).
ROW_INTS_WIDE = 8 + BUCKET_WORDS


# --------------------------------------------------------------------------
# word-level primitives (shared with index construction)
# --------------------------------------------------------------------------


def eq_mask(words: jax.Array, c: jax.Array) -> jax.Array:
    """One bit (at lane position 2j) per 2-bit lane of ``words`` equal
    to ``c``.  ``words`` uint32 (any shape), ``c`` broadcastable 0..3."""
    pat = c.astype(jnp.uint32) * _LANES
    x = words ^ pat
    return jnp.bitwise_not(x | (x >> 1)) & _LANES


def word_count(words: jax.Array, c: jax.Array) -> jax.Array:
    """Count of symbol ``c`` in each full 16-lane word."""
    return jax.lax.population_count(eq_mask(words, c)).astype(jnp.int32)


def word_rank(words: jax.Array, c: jax.Array, r: jax.Array) -> jax.Array:
    """Count of ``c`` among the first ``r`` lanes (r in 0..15)."""
    mask = (jnp.uint32(1) << (2 * r.astype(jnp.uint32))) - jnp.uint32(1)
    return jax.lax.population_count(eq_mask(words, c) & mask).astype(jnp.int32)


# --------------------------------------------------------------------------
# bucket construction (device-side, used by index build)
# --------------------------------------------------------------------------


_BUCKET_PLAIN_MAX = 1 << 20  # module constant so tests can lower it


def make_buckets(words: jax.Array, length: int, *, wide: bool = False):
    """Fused bucket rows from packed BWT words.

    ``words`` — (nwords,) uint32, the compact BWT (sentinel removed),
    zero-padded tail lanes; ``length`` — number of BWT entries.
    Returns ``(buckets, totals)``: (nbuckets+1, 8) int32 rows (the
    final row holds the per-symbol totals and a zero payload, so
    gathers at idx == length stay in range) and the (4,) totals.
    ``wide=True`` builds the 64-bit-clean (nbuckets+1, 12) layout —
    occ checkpoints carried as int64 (split lo/hi in the row), totals
    returned int64.
    """
    nwords = words.shape[0]
    nb = max((nwords + BUCKET_WORDS - 1) // BUCKET_WORDS, 1)
    padded = jnp.zeros((nb * BUCKET_WORDS,), jnp.uint32).at[:nwords].set(words)

    # reduction dtypes pinned: under jax_enable_x64 the default sum/
    # cumsum accumulators widen to int64, which must not leak into the
    # narrow layout's rows
    def _bucket_counts(pw, n_b):
        counts = jnp.stack(
            [word_count(pw, jnp.uint32(c)) for c in range(4)], axis=-1
        )  # (n_b*W, 4)
        return counts.reshape(n_b, BUCKET_WORDS, 4).sum(
            axis=1, dtype=jnp.int32
        )

    if nb <= _BUCKET_PLAIN_MAX:
        # zero the all-pad words, and drop the zero-padded ('A') tail
        # lanes of the last real word so checkpoints are exact
        counts = jnp.stack(
            [word_count(padded, jnp.uint32(c)) for c in range(4)], axis=-1
        )
        real = (jnp.arange(nb * BUCKET_WORDS) < nwords)[:, None]
        counts = counts * real
        pad_lanes = (-length) % 16
        if nwords:
            counts = counts.at[nwords - 1, 0].add(-pad_lanes)
        bucket_counts = counts.reshape(nb, BUCKET_WORDS, 4).sum(
            axis=1, dtype=jnp.int32
        )
    else:
        # wide inputs: on a memory layout tiled in (8, 128) blocks the
        # (nwords, 4) counts temp pads 32x, so this path counts under
        # a lax.scan over 16 bucket-aligned chunks (sequential,
        # 1/16th-size temp, reused buffer; same recipe as
        # ops.suffix.upsample16).  GPU layouts have no such padding;
        # the choice is unmeasured on the H100 (ROADMAP queue 1).  The
        # pad-word zeroing happens on the bucket totals instead of the
        # word counts: all-pad words count only symbol 'A' (code 0,
        # 16 lanes each), so subtracting 16*(pad words in the bucket)
        # and the last real word's pad lanes from column 0 is exact.
        C = 16
        bpc = -(-nb // C)
        wpad = jnp.zeros((C * bpc * BUCKET_WORDS,), jnp.uint32)
        wpad = wpad.at[: nb * BUCKET_WORDS].set(padded)

        def body(carry, wchunk):
            return carry, _bucket_counts(wchunk, bpc)

        _, bcs = jax.lax.scan(
            body, jnp.int32(0),
            wpad.reshape(C, bpc * BUCKET_WORDS))
        bucket_counts = bcs.reshape(C * bpc, 4)[:nb]
        # remove the padding contributions from column 0 ('A'):
        # full pad words within each bucket...
        bidx = jnp.arange(nb, dtype=jnp.int32)
        first_w = bidx * BUCKET_WORDS
        padw = jnp.clip(first_w + BUCKET_WORDS - nwords, 0, BUCKET_WORDS)
        bucket_counts = bucket_counts.at[:, 0].add(-16 * padw)
        # ...and the zero-padded tail lanes of the last real word
        pad_lanes = (-length) % 16
        if nwords:
            bucket_counts = bucket_counts.at[
                (nwords - 1) // BUCKET_WORDS, 0].add(-pad_lanes)
    if wide:
        occ = jnp.concatenate(
            [jnp.zeros((1, 4), jnp.int64),
             jnp.cumsum(bucket_counts.astype(jnp.int64), axis=0)]
        )  # (nb+1, 4) int64
    else:
        occ = jnp.concatenate(
            [jnp.zeros((1, 4), jnp.int32),
             jnp.cumsum(bucket_counts, axis=0, dtype=jnp.int32)]
        )  # (nb+1, 4)
    totals = occ[-1]
    word_rows = jnp.concatenate(
        [
            padded.reshape(nb, BUCKET_WORDS),
            jnp.zeros((1, BUCKET_WORDS), jnp.uint32),
        ]
    )
    word_ints = jax.lax.bitcast_convert_type(word_rows, jnp.int32)
    if wide:
        lo = jax.lax.bitcast_convert_type(
            occ.astype(jnp.uint64).astype(jnp.uint32), jnp.int32
        )
        hi = (occ >> 32).astype(jnp.int32)
        buckets = jnp.concatenate([lo, hi, word_ints], axis=1)
    else:
        buckets = jnp.concatenate([occ, word_ints], axis=1)
    return buckets, totals


def _row_occ(rows: jax.Array) -> jax.Array:
    """Per-symbol occ checkpoints of fetched rows — int32 for the 8-int
    layout, int64 reassembled from lo/hi for the wide layout."""
    if rows.shape[-1] == ROW_INTS:
        return rows[..., :4]
    lo = jax.lax.bitcast_convert_type(
        rows[..., :4], jnp.uint32
    ).astype(jnp.int64)
    return (rows[..., 4:8].astype(jnp.int64) << 32) + lo


def bucket_words(buckets: jax.Array) -> jax.Array:
    """The packed BWT words back out of the bucket rows (flat, padded)."""
    return jax.lax.bitcast_convert_type(
        buckets[:-1, -BUCKET_WORDS:], jnp.uint32
    ).reshape(-1)


# --------------------------------------------------------------------------
# queries (one row-gather each)
# --------------------------------------------------------------------------


def _rows(buckets: jax.Array, i: jax.Array, tp_axis: str | None = None,
          nrows: int | None = None) -> jax.Array:
    """The bucket row covering index ``i`` (one row-gather per query).

    ``tp_axis`` — the checkpoint-local tp-sharded fetch (the explicit
    >HBM-index design, parallel/mesh.py): inside a ``shard_map`` body
    ``buckets`` is this shard's contiguous block of the tp-padded
    global table; each shard gathers the queried rows from its LOCAL
    block (clipped, masked to rows it owns) and one (..., 8) psum over
    the axis reconstructs the true rows.  Callers within one tp group
    must issue identical query sequences (lanes shard over 'dp' only),
    so surrounding while_loops stay collectively consistent."""
    # int32 bucket indices are exact to 2^37 bases (64 bases/bucket),
    # so the wide (int64) index's gathers stay int32-indexed
    bi = (i >> 6).astype(jnp.int32)
    if tp_axis is None:
        return jnp.take(buckets, bi, axis=0)
    oob = None
    if nrows is not None:
        # reproduce the replicated path's jnp.take semantics exactly
        # for out-of-contract indices (the C drivers' documented
        # garbage arithmetic reaches rank/LF with them): negative
        # indices in [-nrows, 0) WRAP, anything further fills with the
        # dtype minimum.  The tp shards' padded tables would otherwise
        # turn them into zero rows — different garbage than the pinned
        # engines (FMIndex.bucket_rows carries the real row count).
        bi = jnp.where(bi < 0, bi + nrows, bi)
        oob = (bi < 0) | (bi >= nrows)
    per = buckets.shape[0]
    local = bi - jax.lax.axis_index(tp_axis) * per
    rows = jnp.take(buckets, jnp.clip(local, 0, per - 1), axis=0)
    rows = jnp.where(((local >= 0) & (local < per))[..., None], rows, 0)
    rows = jax.lax.psum(rows, tp_axis)
    if oob is not None:
        rows = jnp.where(oob[..., None],
                         jnp.iinfo(buckets.dtype).min, rows)
    return rows


def rows2(buckets, endloc, ia, ib, tp_axis=None, nrows=None):
    """Bucket rows covering ``ia`` and ``ib`` through ONE stacked
    gather (and one psum under tp).  Returns
    ``(rows_a, ra, rows_b, rb)`` with ``r*`` the in-bucket offsets.

    Callers that need two row fetches in one loop body (interval
    counts / LF steps touch both ends) MUST use this instead of two
    :func:`_rows` calls.  Two separate calls would lower to two
    data-independent all-reduces under tp; XLA:CPU's thunk runtime
    executes data-independent collectives concurrently per device and
    every shard_map psum shares ``channel_id=1``, so two in-flight
    instances of the same key collide in the in-process rendezvous
    and abort the process (repro: tools/repro_xla_cpu_rendezvous.py).
    The fused form is also one gather + one collective of twice the
    payload instead of two of each."""
    ia = _adjust(endloc, jnp.asarray(ia))
    ib = _adjust(endloc, jnp.asarray(ib))
    rows = _rows(buckets, jnp.stack([ia, ib]), tp_axis, nrows)
    return rows[0], ia & 63, rows[1], ib & 63


def take_sharded(table: jax.Array, idx: jax.Array,
                 tp_axis: str | None = None,
                 size: int | None = None) -> jax.Array:
    """``table[idx]`` for a 1-D lookup table (SA / inverse-SA samples),
    tp-local + psum when ``tp_axis`` is set (same contract as
    :func:`_rows`).  Contract: ``idx`` in the table's GLOBAL range."""
    if tp_axis is None:
        return jnp.take(table, idx)
    oob = None
    if size is not None:
        # same wrap-then-fill emulation as _rows (out-of-contract
        # parity with the replicated path's jnp.take)
        idx = jnp.where(idx < 0, idx + size, idx)
        oob = (idx < 0) | (idx >= size)
    per = table.shape[0]
    local = idx - jax.lax.axis_index(tp_axis).astype(idx.dtype) * per
    x = jnp.take(table, jnp.clip(local, 0, per - 1))
    x = jnp.where((local >= 0) & (local < per), x, 0)
    x = jax.lax.psum(x, tp_axis)
    if oob is not None:
        x = jnp.where(oob, jnp.iinfo(table.dtype).min, x)
    return x


def _lane_masks(r: jax.Array) -> jax.Array:
    """Per payload word, a bit-mask of the lanes below offset ``r``
    (r in 0..64) — uint32 (..., W)."""
    lanes = jnp.clip(
        r[..., None] - 16 * jnp.arange(BUCKET_WORDS, dtype=r.dtype), 0, 16
    )
    shift = (2 * jnp.minimum(lanes, 15)).astype(jnp.uint32)
    return jnp.where(lanes >= 16, _FULL, (jnp.uint32(1) << shift) - jnp.uint32(1))


def _select(cols: jax.Array, i: jax.Array) -> jax.Array:
    """cols[..., i] via one-hot multiply-reduce instead of a dynamic
    gather: chosen for an accelerator where tiny column gathers were
    slow regardless of table size; unmeasured on the H100 (ROADMAP
    queue 1)."""
    n = cols.shape[-1]
    oh = i[..., None] == jnp.arange(n, dtype=jnp.int32)
    # dtype pinned: under jax_enable_x64 (wide indexes) jnp.sum would
    # otherwise widen int32 accumulations to int64
    return jnp.sum(cols * oh, axis=-1, dtype=cols.dtype)


def _row_rank(rows: jax.Array, c: jax.Array, r: jax.Array) -> jax.Array:
    occ_c = _select(_row_occ(rows), c.astype(jnp.int32))
    words = rows[..., -BUCKET_WORDS:].astype(jnp.uint32)
    eq = eq_mask(words, c[..., None])
    cnt = jax.lax.population_count(eq & _lane_masks(r)).astype(jnp.int32)
    return occ_c + cnt.sum(-1, dtype=jnp.int32)


def _row_char(rows: jax.Array, r: jax.Array) -> jax.Array:
    w = _select(rows[..., -BUCKET_WORDS:],
                (r >> 4).astype(jnp.int32)).astype(jnp.uint32)
    return ((w >> (2 * (r & 15)).astype(jnp.uint32)) & 3).astype(jnp.int32)


def _adjust(endloc: jax.Array, idx: jax.Array) -> jax.Array:
    """Sentinel skip: the stored BWT omits the sentinel row
    (seqindex.c:221-225)."""
    return idx - (idx > endloc).astype(idx.dtype)


def rank(buckets, endloc, c, idx, tp_axis=None, nrows=None):
    """rank of ``c`` in ``bwt[0:idx]`` with sentinel skipping.  ``c``
    and ``idx`` broadcast together.  Contract: ``0 <= idx <= length+1``
    (every internal caller satisfies this; beyond it the reference
    reads out of bounds and this layout would count zero-pad lanes)."""
    c = jnp.asarray(c)
    i = _adjust(endloc, jnp.asarray(idx))
    c, i = jnp.broadcast_arrays(c, i)
    return _row_rank(_rows(buckets, i, tp_axis, nrows), c, i & 63)


def row_ranks_all4(rows: jax.Array, r: jax.Array) -> jax.Array:
    """All four symbol ranks from an already-fetched bucket row at
    in-bucket offset ``r``: (..., 4)."""
    words = rows[..., -BUCKET_WORDS:].astype(jnp.uint32)
    mask = _lane_masks(r)
    cnts = [
        jax.lax.population_count(eq_mask(words, jnp.uint32(c)) & mask)
        .astype(jnp.int32)
        .sum(-1, dtype=jnp.int32)
        for c in range(4)
    ]
    return _row_occ(rows) + jnp.stack(cnts, axis=-1)


def ranks_all4(buckets, endloc, idx, tp_axis=None, nrows=None):
    """All four symbol ranks at ``idx`` from a single row-gather:
    (..., 4)."""
    i = _adjust(endloc, jnp.asarray(idx))
    return row_ranks_all4(_rows(buckets, i, tp_axis, nrows), i & 63)


def bwt_char(buckets, endloc, idx, tp_axis=None, nrows=None):
    """Character of the (sentinel-full) BWT at ``idx`` (idx != endloc);
    mirrors seqindex.c:217-218."""
    i = _adjust(endloc, jnp.asarray(idx))
    return _row_char(_rows(buckets, i, tp_axis, nrows), i & 63)


def row_lf(rows, C, endloc, idx, r):
    """LF-mapping from an already-fetched bucket row (``r`` = in-bucket
    offset of the adjusted index).  Same math as :func:`lf`; callers
    that batch several walks through one fetch (ops/search.
    walk_and_window_tp) apply it to each slice."""
    c = _row_char(rows, r)
    Cc = _select(jnp.broadcast_to(C[:4], c.shape + (4,)), c)
    stepped = Cc + _row_rank(rows, c, r)
    return jnp.where(idx == endloc, jnp.zeros_like(stepped), stepped)


def lf(buckets, C, endloc, idx, tp_axis=None, nrows=None):
    """LF-mapping (seqindex.c:214-219), ``lf(endloc) == 0`` — one
    row-gather for both the character and its rank."""
    idx = jnp.asarray(idx)
    i = _adjust(endloc, idx)
    rows = _rows(buckets, i, tp_axis, nrows)
    r = i & 63
    c = _row_char(rows, r)
    Cc = _select(jnp.broadcast_to(C[:4], c.shape + (4,)), c)
    stepped = Cc + _row_rank(rows, c, r)
    return jnp.where(idx == endloc, jnp.zeros_like(stepped), stepped)
