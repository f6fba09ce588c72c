"""The FM-index: build + query state, as a JAX pytree.

Semantics are bit-exact with the reference ``fm_index``
(seqindex.h:14-22, seqindex.c:161-212); the memory layout is not a
translation of it but a fused-bucket design for the accelerator (see
bwt_tpu/ops/rank.py):

  * ``bwt_words``  — compact BWT (sentinel removed), 16 bases per
    uint32 word, little-endian 2-bit lanes; padded with one zero word
    so boundary gathers stay in range.  Kept for serialization
    (fileio.c format) and debugging.
  * ``buckets``    — the hot-path layout: per 64 bases one 32-byte row
    ``[occ_A..occ_T | 4 packed words]``; equivalent information to the
    reference's blocksize-16 ``rank_index`` + packed BWT, restructured
    so every rank/LF query is a single row-gather.  (The reference
    never serializes its rank_index either — it rebuilds on load,
    fileio.c:62-63 — so the layout is parity-free.)
  * ``sa_samples`` — partial suffix array, every 32nd SA entry
    (seqindex.c:173-176).
  * ``C``          — cumulative counts with the sentinel offset:
    ``C[0] = 1`` (seqindex.c:183-187).
  * ``endloc``     — SA position of the sentinel (where ``SA[i]==0``).
  * ``length``     — genome length in bases (static metadata).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from bwt_tpu import codec
from bwt_tpu.ops import rank as rank_ops
from bwt_tpu.ops import suffix

SA_SAMPLE_RATE = 32  # seqindex.c:173-176

_widen = jax.jit(lambda x: x.astype(jnp.int32))


def _pack16_host(codes_u8: np.ndarray) -> np.ndarray:
    """Host-side 16-bases/uint32 pack for the upload (codes must be
    0..3); little-endian 2-bit lanes (base j in bits 2j..2j+1)."""
    L = len(codes_u8)
    pad = (-L) % 16
    if pad:
        codes_u8 = np.concatenate(
            [codes_u8, np.zeros((pad,), np.uint8)])
    # 4 strided uint8 passes + a little-endian uint32 view: ~25x faster
    # than a (n, 16) bitwise_or.reduce at 134 Mb (0.2 s vs 5 s).
    b = (codes_u8[0::4] | (codes_u8[1::4] << 2)
         | (codes_u8[2::4] << 4) | (codes_u8[3::4] << 6))
    return np.ascontiguousarray(b).view(np.uint32)


@functools.partial(jax.jit, static_argnames=("length",))
def _unpack16(packed: jax.Array, length: int) -> jax.Array:
    """Device-side unpack of :func:`_pack16_host` -> (length,) int32.

    Word upsampling goes through ops.suffix.upsample16: a plain
    repeat's (n, 16) broadcast temp tiles with 8x padding, and XLA
    materialized it at 2^29 scale (16 GB)."""
    w = suffix.upsample16(packed, length)
    shift = (jnp.arange(length, dtype=jnp.uint32) & 15) * 2
    return ((w >> shift) & 3).astype(jnp.int32)


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["bwt_words", "buckets", "sa_samples", "C", "endloc",
                 "isa_samples"],
    meta_fields=["length", "sa_rate", "tp_axis"],
)
@dataclasses.dataclass(frozen=True)
class FMIndex:
    bwt_words: jax.Array  # (nwords+1,) uint32
    buckets: jax.Array  # (nbuckets+1, 8) int32
    sa_samples: jax.Array  # (1 + length//sa_rate,) int32
    C: jax.Array  # (5,) int32
    endloc: jax.Array  # () int32
    length: int  # static
    sa_rate: int = SA_SAMPLE_RATE  # static; power of two.  32 is the
    # reference's rate (seqindex.c:173-176) and the serialized format's;
    # denser rates shorten locate's LF walk at 4 B/rate/base extra HBM.
    isa_samples: jax.Array | None = None  # (1 + length//sa_rate,) int32:
    # ISA[i*rate] = SA row of the suffix starting at i*rate.  Optional
    # (absent on reference-format loads, whose file stores no inverse);
    # enables positional range queries (ops.search.isa_window) that
    # replace the drivers' O(interval-width) candidate scans — an
    # algorithmic improvement over the reference's sequential unc_sa
    # scans (single_align.c:218-223, rnaseqtest.c:110-121).
    tp_axis: str | None = None  # static.  When set, this FMIndex is a
    # PER-SHARD view inside a ``shard_map`` body: ``buckets``,
    # ``sa_samples`` and ``isa_samples`` hold this shard's contiguous
    # block of the tp-padded global tables (parallel.mesh.shard_index
    # layout), and every rank/LF/sample gather in ops/{rank,search}
    # resolves as a LOCAL clipped gather + one psum over this axis —
    # the checkpoint-local tp-sharded search for indexes larger than
    # one chip's HBM.  ``length``/``sa_rate``/``C``/``endloc`` stay
    # global.  Never use a tp view outside shard_map (axis_index fails
    # loudly).  See parallel.mesh.tp_view / fmi_spec_tree.

    # -- scalar-friendly conveniences (thin wrappers over ops.rank) -----

    def rank(self, c, idx):
        """rank(c, idx) with sentinel skipping (seqindex.c:221-225)."""
        return rank_ops.rank(
            self.buckets, self.endloc, jnp.asarray(c), jnp.asarray(idx),
            tp_axis=self.tp_axis, nrows=self.bucket_rows,
        )

    def lf(self, idx):
        """LF-mapping (seqindex.c:214-219)."""
        return rank_ops.lf(self.buckets, self.C, self.endloc,
                           jnp.asarray(idx), tp_axis=self.tp_axis,
                           nrows=self.bucket_rows)

    @property
    def nwords(self) -> int:
        return (self.length + codec.BASES_PER_WORD - 1) // codec.BASES_PER_WORD

    @property
    def bucket_rows(self) -> int:
        """Real (unpadded) row count of ``buckets`` — static, from
        ``length``.  tp-sharded gathers clamp GLOBAL indices to this
        before localizing so out-of-contract indices (the C drivers'
        garbage arithmetic reaches rank/LF with them) read the same
        clamped row the replicated path's ``jnp.take`` reads — a tp
        shard's local table is padded, so clamping locally would read
        zeros and the garbage would diverge from the pinned engines."""
        nb = max((self.nwords + rank_ops.BUCKET_WORDS - 1)
                 // rank_ops.BUCKET_WORDS, 1)
        return nb + 1

    @property
    def sample_rows(self) -> int:
        """Real (unpadded) row count of ``sa_samples``/``isa_samples``
        (same clamping contract as :attr:`bucket_rows`)."""
        return 1 + self.length // self.sa_rate


_PACK_PLAIN_MAX = 1 << 20  # module constant so tests can lower it


def pack_words_device(codes: jax.Array, length: int) -> jax.Array:
    """Device-side 2-bit packing into uint32 words (+1 zero pad word).

    On a memory layout tiled in (8, 128) blocks the (nwords, 16) lanes
    view pads 8x, so wide inputs pack under a lax.scan over 16 chunks:
    sequential by construction, the per-chunk temp is 1/16th the size
    and reused (same recipe as ops.suffix.upsample16).  GPU layouts
    have no such padding; the choice is unmeasured on the H100
    (ROADMAP queue 1)."""
    BW = codec.BASES_PER_WORD
    nwords = (length + BW - 1) // BW
    shifts = (2 * jnp.arange(BW, dtype=jnp.uint32))[None, :]
    if nwords <= _PACK_PLAIN_MAX:
        padded = jnp.zeros((nwords * BW,), jnp.uint32)
        padded = padded.at[:length].set(codes.astype(jnp.uint32))
        lanes = padded.reshape(nwords, BW)
        words = jnp.bitwise_or.reduce(lanes << shifts, axis=1)
        return jnp.concatenate([words, jnp.zeros((1,), jnp.uint32)])
    C = 16
    wpc = -(-nwords // C)
    padded = jnp.zeros((C * wpc * BW,), jnp.uint32)
    padded = padded.at[:length].set(codes.astype(jnp.uint32))

    def body(carry, chunk):
        lanes = chunk.reshape(wpc, BW)
        return carry, jnp.bitwise_or.reduce(lanes << shifts, axis=1)

    _, ys = jax.lax.scan(body, jnp.int32(0), padded.reshape(C, wpc * BW))
    words = ys.reshape(-1)[:nwords]
    return jnp.concatenate([words, jnp.zeros((1,), jnp.uint32)])


def _assemble(
    bwt_codes: jax.Array, sa_samples, endloc, length: int, sa_rate: int,
    isa_samples=None, *, wide: bool = False,
) -> FMIndex:
    """``wide=True`` builds the 64-bit-clean index: 12-int bucket rows
    (occ split lo/hi, ops/rank.make_buckets), int64 C / endloc /
    sa_samples / isa_samples.  Same query programs serve both — every
    op follows the array dtypes (csacak.c:517's int32 TODO, done with
    still one int32 row-gather per rank)."""
    idx_dt = jnp.int64 if wide else jnp.int32
    bwt_words = pack_words_device(bwt_codes, length)
    buckets, totals = rank_ops.make_buckets(bwt_words[:-1], length,
                                            wide=wide)
    C = jnp.concatenate(
        [jnp.ones((1,), idx_dt), 1 + jnp.cumsum(totals)]
    ).astype(idx_dt)
    return FMIndex(
        bwt_words=bwt_words,
        buckets=buckets,
        sa_samples=jnp.asarray(sa_samples, idx_dt),
        C=C,
        endloc=jnp.asarray(endloc, idx_dt),
        length=length,
        sa_rate=sa_rate,
        isa_samples=(
            None if isa_samples is None
            else jnp.asarray(isa_samples, idx_dt)
        ),
    )


@functools.partial(jax.jit, static_argnames=("length", "sa_rate", "wide"))
def _finish_index_isa(
    codes: jax.Array, sa: jax.Array, isa: jax.Array, length: int,
    sa_rate: int, wide: bool = False,
) -> FMIndex:
    """Finish with the ISA already in hand (from the doubling loop's
    final rerank): BWT via one permutation sort, no gather, no scatter.
    Output bit-identical to :func:`_finish_index`."""
    bwt, endloc = suffix.bwt_from_isa(codes, isa)
    return _assemble(
        bwt, sa[::sa_rate], endloc, length, sa_rate, isa[::sa_rate],
        wide=wide,
    )


@functools.partial(jax.jit, static_argnames=("length", "sa_rate"))
def _finish_index(
    codes: jax.Array, sa: jax.Array, length: int, sa_rate: int
) -> FMIndex:
    """Finish from an externally supplied SA (sharded builds, tests):
    one scatter rebuilds the ISA, then the sort-based BWT path."""
    m = sa.shape[0]
    isa = jnp.zeros((m,), jnp.int32).at[sa].set(
        jnp.arange(m, dtype=jnp.int32)
    )
    bwt, endloc = suffix.bwt_from_isa(codes, isa)
    return _assemble(
        bwt, sa[::sa_rate], endloc, length, sa_rate, isa[::sa_rate]
    )


def build_index(
    seq, *, sa_sample_rate: int | None = None, verify: bool = False,
    config=None, sa=None, index_dtype="auto",
) -> FMIndex:
    """Build an FM-index from genome codes (or ASCII text).

    Device equivalent of ``make_fmi`` / ``make_fmi_sacak``
    (seqindex.c:161-212): prefix-doubling suffix sort -> BWT gather ->
    popcount checkpoint scan, all on device.  ``sa_sample_rate`` must
    be a power of two; its default comes from config (32 = the
    reference and its file format — denser indexes export by
    downsampling).  ``verify=True`` runs the exact O(n) suffix-array
    checker on device and raises on failure.  A precomputed ``sa``
    (e.g. from :func:`bwt_tpu.parallel.suffix_dist.sharded_suffix_array`
    for beyond-one-chip genomes) skips the sort.
    """
    from bwt_tpu.config import DEFAULT

    cfg = config or DEFAULT
    if sa_sample_rate is None:
        sa_sample_rate = cfg.sa_sample_rate
    if cfg.rank_blocksize != codec.BASES_PER_WORD:
        raise ValueError(
            f"config.rank_blocksize={cfg.rank_blocksize} is structural: "
            f"the packed-word layout fixes it at {codec.BASES_PER_WORD}"
        )
    if sa_sample_rate & (sa_sample_rate - 1):
        raise ValueError("sa_sample_rate must be a power of two")
    if isinstance(seq, (str, bytes)):
        seq = codec.encode_genome(seq)
    # index_dtype: "auto" keeps int32 through the cap and switches to
    # the 64-bit-clean layout past it (csacak.c:517's TODO); explicit
    # np.int64 forces the wide layout at any length (how the int64
    # path is validated without a >2^31-base allocation,
    # tests/test_int64_index.py).  The wide index needs
    # jax_enable_x64 — fail loudly, not by silent truncation.
    if index_dtype == "auto":
        wide = len(seq) > suffix.INT32_MAX_LEN
    else:
        wide = np.dtype(index_dtype) == np.int64
        if not wide and len(seq) > suffix.INT32_MAX_LEN:
            raise ValueError(
                f"genome length {len(seq)} exceeds the int32 FM-index "
                f"cap ({suffix.INT32_MAX_LEN}); pass index_dtype="
                "np.int64 (and enable jax_enable_x64)"
            )
    if wide and not jax.config.jax_enable_x64:
        raise ValueError(
            "the int64 FM-index requires jax_enable_x64 (JAX would "
            "silently truncate 64-bit arrays to int32)"
        )
    # upload packed 16 bases/uint32 (4x less host->device traffic than
    # uint8) and unpack+widen on device.  Codes are 0..3 by the codec
    # contract (the 2-bit pack in ops.suffix._initial_ranks assumes the
    # same).
    host = np.asarray(seq, dtype=np.uint8)
    length = len(host)
    if sa is not None and wide:
        raise ValueError(
            "index_dtype=int64 with a precomputed sa= is not supported "
            "(the sharded build is int32; build through the in-process "
            "suffix sort instead)"
        )

    packed = jnp.asarray(_pack16_host(host))
    if sa is None:
        if wide:
            codes = _unpack16(packed, length)
            sa_d, isa = suffix.suffix_array_with_isa(
                codes, dtype=jnp.int64)
        else:
            # the sort runs straight off the 0.25 B/base packed
            # words — no full-width codes array coexists with its
            # workspace (memory headroom for the largest one-device
            # builds); codes are unpacked AFTER, for the BWT
            # permutation sort
            sa_d, isa = suffix.suffix_array_from_le_words(
                packed, length)
            codes = _unpack16(packed, length)
        if verify and not bool(suffix.verify_suffix_array(codes, sa_d)):
            raise AssertionError("suffix array verification failed")
        return _finish_index_isa(codes, sa_d, isa, length,
                                 sa_sample_rate, wide=wide)
    codes = _unpack16(packed, length)
    sa_d = jnp.asarray(np.asarray(sa, np.int32))
    if verify and not bool(suffix.verify_suffix_array(codes, sa_d)):
        raise AssertionError("suffix array verification failed")
    return _finish_index(codes, sa_d, length, sa_sample_rate)


@functools.partial(jax.jit, static_argnames=("length", "sa_rate"))
def _assemble_jit(bwt_codes, sa_samples, endloc, length: int, sa_rate: int):
    return _assemble(bwt_codes, sa_samples, endloc, length, sa_rate)


def index_from_parts(
    *, bwt_codes, sa_samples, C, endloc, length: int, sa_rate: int = SA_SAMPLE_RATE
) -> FMIndex:
    """Reassemble an FMIndex from serialized parts (rank checkpoints are
    rebuilt, mirroring read_index, fileio.c:62-63).  The stored C is
    recomputed from the BWT (identical by construction)."""
    del C  # rebuilt, like the reference's rank_index
    return _assemble_jit(
        jnp.asarray(np.asarray(bwt_codes), jnp.uint32),
        jnp.asarray(np.asarray(sa_samples), jnp.int32),
        jnp.asarray(endloc, jnp.int32),
        length,
        sa_rate,
    )


def bwt_codes(fmi: FMIndex) -> np.ndarray:
    """Compact BWT as uint8 codes (host)."""
    return codec.unpack_words(np.asarray(fmi.bwt_words[:-1]), fmi.length)
