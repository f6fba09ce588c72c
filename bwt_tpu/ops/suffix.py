"""Suffix-array construction on the accelerator via prefix doubling.

The reference builds suffix arrays with a recursive MSD histogram sort
(histsortcomp.c:35-180) or SACA-K induced sorting (csacak.c:456-528) —
pointer-chasing recursion that does not map onto data-parallel hardware.
The idiomatic replacement is prefix doubling (Manber-Myers): O(log n)
rounds of a fully data-parallel multi-key sort (`jax.lax.sort`), each
round doubling the compared prefix length. Random DNA needs only
~log4(n) effective depth, so the dynamic while_loop usually exits after
a handful of rounds.

Conventions match the reference exactly:
  * the SA is built over ``seq + sentinel`` where the sentinel sorts
    before every base (histsortcomp.c:161-180: ``arr[0] = len``);
  * SA has length ``len+1`` with values in ``0..len``; ``SA[0] == len``
    always (the sentinel suffix), and the position ``i`` with
    ``SA[i] == 0`` is the BWT sentinel location ``endloc``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


_INIT_K = 12  # initial rank prefix length (24-bit values)

# Largest genome an int32 SA can index: the SA spans len+1 entries with
# values 0..len, so len+1 must fit int32.  The reference shares this cap
# (TODO at csacak.c:517); past it, use ``suffix_array(..., dtype=int64)``
# (requires jax_enable_x64).
INT32_MAX_LEN = (1 << 31) - 2


def _initial_ranks(codes: jax.Array, length: int,
                   dtype=jnp.int32) -> jax.Array:
    """Order-consistent initial ranks over 12-character prefixes.

    Packs the genome big-endian (first char in the high bits) 16 bases
    per uint32 word, then reads each position's 24-bit prefix value
    from the (at most) two words it spans.  Windows running past the
    end read zero-padding ('A') — with two corrections that make the
    key order-consistent with true sentinel ordering:

      * a window containing the sentinel is unique, so tail positions
        (i > length-12) get a tie-break digit ordering them below any
        equal-valued full window and among themselves shortest-first
        (the sentinel sorts before every base);
      * every remaining merge is between *full* windows, whose tie the
        doubling rounds break via genuine in-range ranks at i+k.

    Ranks need not be dense: each round's sort+re-rank densifies.
    """
    nwords = (length + 15) // 16 + 1
    padded = jnp.zeros((nwords * 16,), jnp.uint32).at[:length].set(
        codes.astype(jnp.uint32)
    )
    shifts = (2 * (15 - jnp.arange(16, dtype=jnp.uint32)))[None, :]
    be = jnp.bitwise_or.reduce(
        padded.reshape(nwords, 16) << shifts, axis=1
    )  # (nwords,) big-endian words
    i = jnp.arange(length, dtype=dtype)
    o = (2 * (i & 15)).astype(jnp.uint32)
    # word i>>4 and its successor, as strided broadcasts — NOT gathers
    # (these repeats stream at memory bandwidth; a dynamic gather need
    # not)
    w0 = jnp.repeat(be[:-1], 16)[:length]
    w1 = jnp.repeat(jnp.concatenate([be[1:], be[:1] * 0]), 16)[:length]
    hi = (w0 << o) | jnp.where(o > 0, w1 >> (32 - o), 0)
    vals = (hi >> 8).astype(dtype)  # top 24 bits = 12-char prefix
    # tail tie-break: t in 1..12 counts how far the sentinel intrudes
    tie = (12 - jnp.clip(i - (length - _INIT_K), 0, _INIT_K)).astype(dtype)
    keys = vals * 13 + tie
    return jnp.concatenate([keys + 1, jnp.zeros((1,), dtype)])


@functools.partial(jax.jit, static_argnames=("length", "dtype"))
def _suffix_array_impl(codes: jax.Array, length: int,
                       dtype=jnp.int32) -> jax.Array:
    """SA over codes + sentinel.  codes: (length,) int in 0..3.

    The int64-SA variant (>2^31 genomes, jax_enable_x64 runs): the
    original 3-array (r, r2, idx) 2-key sort — the packed-key loop
    below would need an int128 key there."""
    m = length + 1
    idx = jnp.arange(m, dtype=dtype)
    done0 = jnp.array(False)
    # (Rounds stay narrow 2-key sorts: folding two doubling rounds
    # into one 3-key sort lost on the earlier accelerator; unmeasured
    # on the H100.)
    if m > _INIT_K + 1:
        r = _initial_ranks(codes, length, dtype)
        k0 = _INIT_K
    else:
        # tiny inputs: 1-character prefix order; sentinel gets rank 0
        r = jnp.concatenate(
            [codes.astype(dtype) + 1, jnp.zeros((1,), dtype)]
        )
        k0 = 1

    def cond(state):
        r, k, done = state
        return jnp.logical_and(k < m, jnp.logical_not(done))

    fill = jnp.full((m,), -1, dtype)

    def body(state):
        r, k, _ = state
        # Second key: rank of the suffix k positions ahead; past-end
        # sorts first (never matters once the sentinel is in play, but
        # keeps the comparison total).  The shift is a dynamic_slice of
        # the padded array, not a gather: a streaming copy.
        r2 = jax.lax.dynamic_slice(
            jnp.concatenate([r, fill]), (k,), (m,)
        )
        # The sort returns the permuted keys alongside the payload —
        # re-gathering them through ``sa`` would cost two more
        # random-gather passes.
        kr, kr2, sa = jax.lax.sort((r, r2, idx), num_keys=2)
        changed = jnp.concatenate(
            [
                jnp.zeros((1,), dtype),
                (
                    (kr[1:] != kr[:-1]) | (kr2[1:] != kr2[:-1])
                ).astype(dtype),
            ]
        )
        ranks_sorted = jnp.cumsum(changed)
        new_r = jnp.zeros_like(r).at[sa].set(ranks_sorted)
        # Exact termination test on the freshly *dense* ranks: all m
        # suffixes separated.  (Testing the carried ranks before the
        # first round would be wrong: the initial ranks are not dense,
        # and max(r) == m-1 can hold coincidentally with duplicates —
        # e.g. codes "AAG" gives 1-char ranks [1,1,3,0].)
        done = ranks_sorted[-1] == m - 1
        return new_r, k * 2, done

    r, _, _ = jax.lax.while_loop(
        cond, body, (r, jnp.asarray(k0, dtype), done0)
    )
    # r is now a permutation: r[i] = lexicographic rank of suffix i —
    # i.e. r IS the inverse suffix array.  Returning it alongside sa
    # lets build_index skip its own full-length ISA scatter (a ~1.3 s
    # dynamic-scatter pass at 134 Mb) — the loop's final rerank already
    # paid for it.
    sa = jnp.zeros((m,), dtype).at[r].set(idx)
    return sa, r


# upper bound on the non-dense round-1 ranks (_initial_ranks: keys =
# vals*13 + tie + 1 with vals < 2^24, tie <= 12); the packed-key stride
# must exceed max(r2) + 1 in EVERY round — after round 1 ranks are
# dense (< m), but round 1 itself carries these
_INIT_RANK_BOUND = 13 * ((1 << 24) - 1) + 14


@functools.partial(jax.jit, static_argnames=("length",))
def _le_to_be_words(packed: jax.Array, length: int) -> jax.Array:
    """index._pack16_host's little-endian 2-bit lanes -> the big-endian
    word layout :func:`_initial_ranks` builds (base 0 in the top bits),
    with the trailing zero word appended.  Pure per-word bit shuffle
    (reverse the order of the 16 2-bit groups): runs at streaming
    bandwidth, so the suffix sort can take the 0.25 B/base packed
    upload directly instead of a materialized (m,) int32 codes array."""
    w = packed.astype(jnp.uint32)
    w = ((w & 0x33333333) << 2) | ((w >> 2) & 0x33333333)
    w = ((w & 0x0F0F0F0F) << 4) | ((w >> 4) & 0x0F0F0F0F)
    w = ((w & 0x00FF00FF) << 8) | ((w >> 8) & 0x00FF00FF)
    w = (w << 16) | (w >> 16)
    nwords = (length + 15) // 16 + 1
    pad = nwords - w.shape[0]
    if pad > 0:
        w = jnp.concatenate([w, jnp.zeros((pad,), jnp.uint32)])
    return w[:nwords]


@functools.partial(jax.jit, static_argnames=("length",))
def _be_words_from_codes(codes: jax.Array, length: int) -> jax.Array:
    """The big-endian packing step of :func:`_initial_ranks`, exposed
    so the public entry points can shrink codes to 0.25 B/base BEFORE
    the sort loop runs (the caller's codes array then sits outside the
    loop's peak)."""
    nwords = (length + 15) // 16 + 1
    padded = jnp.zeros((nwords * 16,), jnp.uint32).at[:length].set(
        codes.astype(jnp.uint32)
    )
    shifts = (2 * (15 - jnp.arange(16, dtype=jnp.uint32)))[None, :]
    return jnp.bitwise_or.reduce(
        padded.reshape(nwords, 16) << shifts, axis=1
    )


_UPSAMPLE_PLAIN_MAX = 1 << 20  # module constant so tests can lower it


def upsample16(words: jax.Array, length: int) -> jax.Array:
    """``out[i] = words[i // 16]`` without a full-width tiled temp.

    ``jnp.repeat(words, 16)`` lowers to a broadcast of shape (nw, 16).
    On a memory layout tiled in (8, 128) blocks that temp pads 8x, so
    this path was written for such a layout: a lax.scan over 16 word
    chunks is sequential by construction, the per-chunk temp is 1/16th
    the size and its buffer is reused across iterations; chunk outputs
    stack in position order (chunk-major == position-major), so no
    transpose is needed.  GPU layouts are row-major with no such
    padding; the plain-vs-chunked choice is unmeasured on the H100
    (ROADMAP queue 1)."""
    nw = words.shape[0]
    if nw <= _UPSAMPLE_PLAIN_MAX:  # small inputs: plain form fits
        return jnp.repeat(words, 16)[:length]
    C = 16
    wpc = -(-nw // C)
    pad = C * wpc - nw
    wp = jnp.concatenate([words, jnp.zeros((pad,), words.dtype)]) \
        if pad else words

    def body(carry, wchunk):
        return carry, jnp.repeat(wchunk, 16)

    _, ys = jax.lax.scan(body, jnp.int32(0), wp.reshape(C, wpc))
    return ys.reshape(-1)[:length]


def _initial_ranks_from_be(be: jax.Array, length: int,
                           dtype=jnp.int32) -> jax.Array:
    """:func:`_initial_ranks` from pre-packed big-endian words (same
    values; the packing moved to the caller)."""
    i = jnp.arange(length, dtype=dtype)
    o = (2 * (i & 15)).astype(jnp.uint32)
    # ONE upsample serves both word reads: up[i] = be[i>>4] and
    # up[i+16] = be[(i>>4)+1] (be carries a trailing zero word)
    up = upsample16(be, length + 16)
    w0 = up[:length]
    w1 = up[16:16 + length]
    hi = (w0 << o) | jnp.where(o > 0, w1 >> (32 - o), 0)
    vals = (hi >> 8).astype(dtype)
    tie = (12 - jnp.clip(i - (length - _INIT_K), 0, _INIT_K)).astype(dtype)
    keys = vals * 13 + tie
    return jnp.concatenate([keys + 1, jnp.zeros((1,), dtype)])


@functools.partial(jax.jit, static_argnames=("length",))
def _suffix_array_impl_packed(be: jax.Array, length: int):
    """int32 SA via a PACKED single-key sort over the 2-bit word form
    (VERDICT r4 #2 — the memory-frugal build regime; the reference
    chose SACA-K expressly for its O(1) workspace, csacak.c:456-528 /
    README.md:72-79).

    Takes the genome as big-endian 2-bit packed words (0.25 B/base —
    :func:`_le_to_be_words` / :func:`_be_words_from_codes`), so no
    full-width codes array exists during the sort.  Each doubling
    round packs (r, r2) into ONE int64 key ``r * stride + (r2 + 1)``
    with ``stride > max(r2) + 1`` in every round (round 1's ranks are
    NOT dense — bounded by :data:`_INIT_RANK_BOUND` — later rounds'
    are < m), and sorts (key, idx) instead of the 3-array (r, r2, idx)
    2-key sort.  Injectivity makes adjacent-equality of the packed key
    exactly pairwise equality of (r, r2), so the rerank logic is
    unchanged and the output bit-identical (lax.sort is stable; equal
    pairs <=> equal keys keep the same tie groups).  Peak workspace
    drops from ~10 live int32 words/base (3 sort arrays in + 3 out,
    carry, slice concat, rerank) to ~6 (key 2w + idx 1w in, key 2w +
    sa 1w out) — the same 12 B/element moves through the comparator,
    so round time is neutral; max key ~ m * stride < 2^60 at the int32
    length cap.

    Requires x64 enabled at trace time for the int64 key; the public
    entry points wrap the call in ``jax.enable_x64()``.  All
    inputs/outputs are int32/uint32."""
    dtype = jnp.int32
    m = length + 1
    idx = jnp.arange(m, dtype=dtype)
    done0 = jnp.array(False)
    if m > _INIT_K + 1:
        r = _initial_ranks_from_be(be, length, dtype)
        k0 = _INIT_K
    else:
        # tiny inputs: 1-character prefix order via a direct unpack
        i = jnp.arange(length, dtype=jnp.uint32)
        w = jnp.repeat(be, 16)[:length]
        c = (w >> (2 * (15 - (i & 15)))) & 3
        r = jnp.concatenate(
            [c.astype(dtype) + 1, jnp.zeros((1,), dtype)]
        )
        k0 = 1

    def cond(state):
        r, k, done = state
        return jnp.logical_and(k < m, jnp.logical_not(done))

    fill = jnp.full((m,), -1, dtype)
    stride = jnp.int64(max(m + 2, _INIT_RANK_BOUND + 2))

    def body(state):
        r, k, _ = state
        r2 = jax.lax.dynamic_slice(
            jnp.concatenate([r, fill]), (k,), (m,)
        )
        key = r.astype(jnp.int64) * stride + (r2 + 1).astype(jnp.int64)
        key_s, sa = jax.lax.sort((key, idx), num_keys=1)
        changed = jnp.concatenate(
            [
                jnp.zeros((1,), dtype),
                (key_s[1:] != key_s[:-1]).astype(dtype),
            ]
        )
        ranks_sorted = jnp.cumsum(changed, dtype=dtype)
        new_r = jnp.zeros_like(r).at[sa].set(ranks_sorted)
        done = ranks_sorted[-1] == m - 1
        return new_r, k * 2, done

    r, _, _ = jax.lax.while_loop(
        cond, body, (r, jnp.asarray(k0, dtype), done0)
    )
    sa = jnp.zeros((m,), dtype).at[r].set(idx)
    return sa, r


def suffix_array_from_le_words(packed, length: int):
    """(SA, ISA) straight from index._pack16_host's upload words — the
    maximum-headroom build path: the only full-width arrays that ever
    exist are the sort loop's own ~6 words/base (index.build_index
    unpacks codes AFTER the sort, for the BWT)."""
    if length > INT32_MAX_LEN:
        raise ValueError(
            f"genome length {length} exceeds the int32 suffix-array cap "
            f"({INT32_MAX_LEN}); build through suffix_array_with_isa "
            "with dtype=np.int64"
        )
    be = _le_to_be_words(jnp.asarray(packed), length)
    with jax.enable_x64():
        return _suffix_array_impl_packed(be, length)


def suffix_array(
    codes, *, device: bool = True, dtype=jnp.int32
) -> np.ndarray | jax.Array:
    """Suffix array of ``codes + sentinel`` (length ``len(codes)+1``).

    Bit-exact with the reference's ``histsort`` (histsortcomp.c:161)
    and ``csuff_arr`` (csacak.c:521) outputs: suffixes of the
    sentinel-terminated string are unique, so every correct algorithm
    yields the identical array.

    ``dtype``: int32 (default) caps genomes at :data:`INT32_MAX_LEN`
    bases — past it, a loud ValueError (the reference overflows
    silently, csacak.c:517's TODO).  Pass ``np.int64`` for the
    64-bit-clean variant (identical output values; requires
    ``jax_enable_x64`` so JAX does not silently downcast — e.g.
    ``with jax.enable_x64(): ...``)."""
    # guards run BEFORE any device upload (a >2^31 input is gigabytes)
    n = int(codes.shape[0]) if hasattr(codes, "shape") else len(codes)
    dt = np.dtype(dtype)
    if dt == np.int32:
        if n > INT32_MAX_LEN:
            raise ValueError(
                f"genome length {n} exceeds the int32 suffix-array cap "
                f"({INT32_MAX_LEN}); pass dtype=np.int64 (and enable "
                "jax_enable_x64) for the 64-bit variant"
            )
    elif dt == np.int64:
        if not jax.config.jax_enable_x64:
            raise ValueError(
                "dtype=int64 requires jax_enable_x64 (JAX would "
                "silently downcast to int32); wrap the call in "
                "jax.enable_x64() or set the config flag"
            )
    else:
        raise ValueError(f"unsupported SA dtype {dt} (int32 or int64)")
    codes = jnp.asarray(codes)
    if codes.dtype != jnp.int32:
        # widen on device: uploading uint8 beats uploading int32 4:1
        codes = codes.astype(jnp.int32)
    if dt == np.int32:
        be = _be_words_from_codes(codes, n)
        with jax.enable_x64():
            arr, _ = _suffix_array_impl_packed(be, n)
    else:
        arr, _ = _suffix_array_impl(codes, n, dtype)
    return arr if device else np.asarray(arr)


def suffix_array_with_isa(codes, *, dtype=jnp.int32):
    """(SA, ISA) in one pass — the ISA falls out of the doubling loop's
    final rerank for free (``ISA[p]`` = SA row of the suffix starting at
    ``p``); callers that need both (index builds) skip a full-length
    scatter.  Same guards and bit-exact outputs as :func:`suffix_array`.
    (For the maximum-memory-headroom build, hand the packed upload
    words to :func:`suffix_array_from_le_words` instead — then no
    full-width codes array coexists with the sort loop.)
    """
    n = int(codes.shape[0]) if hasattr(codes, "shape") else len(codes)
    if np.dtype(dtype) == np.int32 and n > INT32_MAX_LEN:
        raise ValueError(
            f"genome length {n} exceeds the int32 suffix-array cap "
            f"({INT32_MAX_LEN}); pass dtype=np.int64 (and enable "
            "jax_enable_x64) for the 64-bit variant"
        )
    codes = jnp.asarray(codes)
    if codes.dtype != jnp.int32:
        codes = codes.astype(jnp.int32)
    if np.dtype(dtype) == np.int32:
        be = _be_words_from_codes(codes, n)
        with jax.enable_x64():
            return _suffix_array_impl_packed(be, n)
    return _suffix_array_impl(codes, n, dtype)


@functools.partial(jax.jit, static_argnames=())
def verify_suffix_array(codes: jax.Array, sa: jax.Array) -> jax.Array:
    """Exact O(n) suffix-array verification (device, scalar bool).

    The classic linear checker: ``sa`` is valid iff (a) it is a
    permutation of 0..m-1 and (b) every adjacent pair satisfies
    ``text[sa[i]] < text[sa[i+1]]`` or (chars equal and the *claimed*
    rank of the successor suffixes increases) — condition (b) over the
    claimed inverse permutation is sufficient by induction on suffix
    length.  Used as a safety net after construction (an SA bug once
    slipped past max-rank heuristics; this check is exact).
    """
    codes = jnp.asarray(codes, jnp.int32)
    sa = jnp.asarray(sa, jnp.int32)
    m = sa.shape[0]
    idx = jnp.arange(m, dtype=jnp.int32)
    counts = jnp.zeros((m,), jnp.int32).at[sa].add(1, mode="drop")
    perm_ok = jnp.all(counts == 1) & jnp.all((sa >= 0) & (sa < m))
    inv = jnp.zeros((m,), jnp.int32).at[jnp.clip(sa, 0, m - 1)].set(idx)
    ext = jnp.concatenate([codes + 1, jnp.zeros((1,), jnp.int32)])  # sentinel 0
    c1 = jnp.take(ext, sa[:-1], mode="clip")
    c2 = jnp.take(ext, sa[1:], mode="clip")
    nr1 = jnp.take(inv, sa[:-1] + 1, mode="fill", fill_value=-1)
    nr2 = jnp.take(inv, sa[1:] + 1, mode="fill", fill_value=-1)
    order_ok = jnp.all((c1 < c2) | ((c1 == c2) & (nr1 < nr2)))
    return perm_ok & order_ok


def bwt_from_sa(codes: jax.Array, sa: jax.Array):
    """Derive the compact BWT (sentinel removed) from seq + SA.

    Mirrors ``sprintcbwt`` (histsortcomp.c:220-250): for each SA entry
    with ``SA[i] != 0`` emit ``seq[SA[i]-1]``; the single entry with
    ``SA[i] == 0`` (position ``endloc``) is skipped, compacting later
    entries down by one.  Returns ``(bwt_codes[len], endloc)``.
    """
    codes = jnp.asarray(codes)
    sa = jnp.asarray(sa)
    m = sa.shape[0]
    endloc = jnp.argmin(sa).astype(jnp.int32)  # SA[endloc] == 0, unique
    j = jnp.arange(m - 1, dtype=jnp.int32)
    # skip the sentinel row: select between the two static shifts of sa
    # (streaming) instead of gathering at j + (j >= endloc)
    prev = jnp.where(j >= endloc, sa[1:], sa[:-1]) - 1
    bwt = jnp.take(codes, prev)  # the genuine random gather
    return bwt, endloc


def bwt_from_isa(codes: jax.Array, isa: jax.Array):
    """BWT via one permutation sort instead of a random gather.

    Same emitted sequence as :func:`bwt_from_sa` (sprintcbwt,
    histsortcomp.c:220-250), built the other way around: the BWT row
    that holds ``codes[p]`` follows in closed form from the ISA — with
    ``i = ISA[p+1]`` (the SA row of the suffix starting at ``p+1``) the
    emitting row is ``i`` before the skipped sentinel row and ``i-1``
    after it.  Sorting ``codes`` by that key applies the permutation at
    ``lax.sort`` cost, which beat the equivalent dynamic gather on the
    earlier accelerator (unmeasured on the H100).  ``endloc`` is ``ISA[0]`` by
    definition (``SA[endloc] == 0``).  Returns ``(bwt_codes, endloc)``.
    """
    codes = jnp.asarray(codes)
    isa = jnp.asarray(isa)
    endloc = isa[0]  # keeps the ISA's dtype (int64 for wide indexes)
    tail = isa[1:]
    prev_inv = tail - (tail > endloc).astype(tail.dtype)
    _, bwt = jax.lax.sort((prev_inv, codes), num_keys=1)
    return bwt, endloc


def naive_bwt_ascii(text: str) -> str:
    """The `./bwt mississippi` parity path (bwt.c:13-61).

    BWT of an arbitrary ASCII string with a prepended NUL sentinel,
    printed with '$' in place of the sentinel.  Tiny inputs only; uses
    argsort of rotations.
    """
    s = "\0" + text
    n = len(s)
    doubled = s + s
    order = sorted(range(n), key=lambda i: doubled[i : i + n])
    out = [s[(i - 1) % n] for i in order]
    return "".join("$" if ch == "\0" else ch for ch in out)
