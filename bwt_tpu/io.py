"""Index persistence.

Two formats:
  * the reference binary format (fileio.c:8-18) for drop-in
    interoperability: ``int32 len | int32 C[5] | int32 endloc |
    int32 idxs[1+len/32] | uint8 bwt[(len+3)/4]`` (little-endian,
    reference big-endian-within-byte 2-bit packing).  Rank checkpoints
    and lookup tables are deliberately not stored — they are rebuilt on
    load (fileio.c:62-63).
  * a native ``.npz`` format that round-trips the device word layout
    directly.  The schema is 64-bit-clean: ``length`` is stored int64
    and every array round-trips with its dtype verbatim — an int64
    (wide) index built with ``build_index(..., index_dtype=np.int64)``
    writes int64 ``sa_samples``/``isa_samples``/``C``/``endloc`` and
    12-int bucket rows, and loads back unchanged (under
    ``jax_enable_x64``; tests/test_int64_index.py).  The reference
    format is int32 by definition (fileio.c:11-15) and refuses lengths
    past the int32 cap.
"""

from __future__ import annotations

import io as _io
from pathlib import Path

import numpy as np

from bwt_tpu import codec
from bwt_tpu.index import FMIndex, index_from_parts


def write_ref_index(fmi: FMIndex, path) -> None:
    """Serialize in the reference's fileio.c format (SA samples at
    rate 32; denser in-memory indexes are downsampled)."""
    if fmi.sa_rate > 32 or 32 % fmi.sa_rate:
        raise ValueError(
            f"reference format needs sa_rate dividing 32, got {fmi.sa_rate}"
        )
    samples = np.asarray(fmi.sa_samples)[:: 32 // fmi.sa_rate]
    buf = _io.BytesIO()
    length = fmi.length
    buf.write(np.int32(length).tobytes())
    buf.write(np.asarray(fmi.C, dtype="<i4").tobytes())
    buf.write(np.int32(int(fmi.endloc)).tobytes())
    buf.write(np.asarray(samples, dtype="<i4").tobytes())
    words = np.asarray(fmi.bwt_words[:-1])
    buf.write(codec.words_to_ref_bytes(words, length).tobytes())
    Path(path).write_bytes(buf.getvalue())


def read_ref_index(path) -> FMIndex:
    """Load a fileio.c-format index (rank checkpoints rebuilt).

    Short files raise a clear ``ValueError`` — the reference detects a
    short read and returns NULL ("Could not read index",
    fileio.c:57-60) instead of parsing garbage."""
    raw = Path(path).read_bytes()
    off = 0

    def take(n_int32, what):
        nonlocal off
        if off + 4 * n_int32 > len(raw):
            raise ValueError(
                f"Could not read index {path}: truncated file "
                f"({len(raw)} bytes, need {off + 4 * n_int32} through "
                f"{what}; fileio.c:57-60 returns NULL here)"
            )
        arr = np.frombuffer(raw, dtype="<i4", count=n_int32, offset=off)
        off += 4 * n_int32
        return arr

    length = int(take(1, "length")[0])
    if length < 0:
        raise ValueError(
            f"Could not read index {path}: negative length {length}"
        )
    C = take(5, "C").copy()
    endloc = int(take(1, "endloc")[0])
    n_samples = 1 + length // 32
    sa_samples = take(n_samples, "SA samples").copy()
    nbytes = (length + 3) // 4
    if off + nbytes > len(raw):
        raise ValueError(
            f"Could not read index {path}: truncated file "
            f"({len(raw)} bytes, need {off + nbytes} through the packed "
            f"BWT; fileio.c:57-60 returns NULL here)"
        )
    packed = np.frombuffer(raw, dtype=np.uint8, count=nbytes, offset=off)
    bwt = codec.unpack_ref_bytes(packed, length)
    return index_from_parts(
        bwt_codes=bwt, sa_samples=sa_samples, C=C, endloc=endloc, length=length
    )


def write_npz_index(fmi: FMIndex, path) -> None:
    extra = {}
    if fmi.isa_samples is not None:
        extra["isa_samples"] = np.asarray(fmi.isa_samples)
    np.savez_compressed(
        path,
        version=np.int32(2),
        length=np.int64(fmi.length),
        sa_rate=np.int32(fmi.sa_rate),
        bwt_words=np.asarray(fmi.bwt_words),
        buckets=np.asarray(fmi.buckets),
        sa_samples=np.asarray(fmi.sa_samples),
        C=np.asarray(fmi.C),
        endloc=np.asarray(fmi.endloc),
        **extra,
    )


def read_npz_index(path) -> FMIndex:
    import jax.numpy as jnp

    z = np.load(path)
    return FMIndex(
        bwt_words=jnp.asarray(z["bwt_words"]),
        buckets=jnp.asarray(z["buckets"]),
        sa_samples=jnp.asarray(z["sa_samples"]),
        C=jnp.asarray(z["C"]),
        endloc=jnp.asarray(z["endloc"]),
        length=int(z["length"]),
        sa_rate=int(z["sa_rate"]) if "sa_rate" in z else 32,
        isa_samples=(
            jnp.asarray(z["isa_samples"]) if "isa_samples" in z else None
        ),
    )
