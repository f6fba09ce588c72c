"""2-bit nucleotide codec: ASCII <-> codes <-> packed layouts.

The reference (yichizhng/bwt) stores genomes 2-bit packed, 4 bases per
byte, big-endian *within* the byte: base at index ``i`` lives in byte
``i >> 2`` at bit offset ``2*(3 - (i & 3))`` (see seqindex.c:18-21,
``getbase``).  We keep that byte layout only as a *serialization /
parity* format.

The device working layout packs 16 bases per ``uint32`` word with
little-endian 2-bit lanes (base ``j`` of a word at bits ``2*j``): lane
extraction and 2-bit-symbol popcounts become shift/mask/popcount chains
the VPU executes directly, with no byte-order shuffling.

Code values:
  genome: A=0, C=1, G=2, T=3; any other character -> 0 ('A'), matching
          the reference ingest loops (build_index.c:54-88).
  reads:  A=0, C=1, G=2, T=3; any other character -> 5 ('N'), matching
          single_align.c:450-474.  Code 5 means "matches anything".
"""

from __future__ import annotations

import numpy as np

A, C, G, T, N = 0, 1, 2, 3, 5

BASES_PER_WORD = 16  # 2-bit lanes in a uint32
NT_CHARS = "ACGT"

# --- ASCII lookup tables ------------------------------------------------

_GENOME_LUT = np.zeros(256, dtype=np.uint8)  # default: 0 ('A')
_READ_LUT = np.full(256, N, dtype=np.uint8)  # default: 5 ('N')
for _i, _ch in enumerate(NT_CHARS):
    _GENOME_LUT[ord(_ch)] = _i
    _READ_LUT[ord(_ch)] = _i

# Complement: A<->T, C<->G; N (5) stays N.
_COMPLEMENT = np.arange(256, dtype=np.uint8)
_COMPLEMENT[:4] = [3, 2, 1, 0]
_COMPLEMENT[N] = N


def _as_bytes(s) -> bytes:
    if isinstance(s, str):
        return s.encode("ascii")
    return bytes(s)


def encode_genome(s) -> np.ndarray:
    """ASCII genome text -> uint8 codes 0-3 (non-ACGT -> A=0)."""
    raw = np.frombuffer(_as_bytes(s), dtype=np.uint8)
    return _GENOME_LUT[raw]


def encode_read(s) -> np.ndarray:
    """ASCII read -> uint8 codes 0-3 / 5 (non-ACGT -> N=5)."""
    raw = np.frombuffer(_as_bytes(s), dtype=np.uint8)
    return _READ_LUT[raw]


def decode(codes) -> str:
    """Codes -> ASCII (5 -> 'N')."""
    codes = np.asarray(codes, dtype=np.uint8)
    lut = np.frombuffer(b"ACGT.N", dtype=np.uint8)
    return lut[codes].tobytes().decode("ascii")


def revcomp(codes) -> np.ndarray:
    """Reverse complement of a code array; N (5) maps to N."""
    codes = np.asarray(codes, dtype=np.uint8)
    return _COMPLEMENT[codes][::-1]


# --- reference byte layout (serialization / parity) ----------------------


def pack_ref_bytes(codes) -> np.ndarray:
    """Codes 0-3 -> packed bytes in the reference layout.

    Byte ``i>>2`` holds base ``i`` at bits ``2*(3-(i&3))`` (big-endian
    within the byte); trailing lanes are zero-filled, matching the
    reference's A-padding (seqindex.c:18-21).
    """
    codes = np.asarray(codes, dtype=np.uint8)
    n = len(codes)
    nbytes = (n + 3) // 4
    padded = np.zeros(nbytes * 4, dtype=np.uint8)
    padded[:n] = codes
    lanes = padded.reshape(nbytes, 4)
    return (
        (lanes[:, 0] << 6) | (lanes[:, 1] << 4) | (lanes[:, 2] << 2) | lanes[:, 3]
    ).astype(np.uint8)


def unpack_ref_bytes(packed, length: int) -> np.ndarray:
    """Packed reference-layout bytes -> codes 0-3 of ``length``."""
    packed = np.asarray(packed, dtype=np.uint8)
    lanes = np.empty((len(packed), 4), dtype=np.uint8)
    lanes[:, 0] = (packed >> 6) & 3
    lanes[:, 1] = (packed >> 4) & 3
    lanes[:, 2] = (packed >> 2) & 3
    lanes[:, 3] = packed & 3
    return lanes.reshape(-1)[:length].copy()


# --- device word layout ---------------------------------------------------


def pack_words(codes) -> np.ndarray:
    """Codes 0-3 -> uint32 words, 16 little-endian 2-bit lanes per word.

    Base ``i`` lives in word ``i >> 4`` at bits ``2*(i & 15)``.
    Trailing lanes zero-filled.
    """
    codes = np.asarray(codes, dtype=np.uint32)
    n = len(codes)
    nwords = (n + BASES_PER_WORD - 1) // BASES_PER_WORD
    padded = np.zeros(nwords * BASES_PER_WORD, dtype=np.uint32)
    padded[:n] = codes
    lanes = padded.reshape(nwords, BASES_PER_WORD)
    shifts = (2 * np.arange(BASES_PER_WORD, dtype=np.uint32))[None, :]
    return np.bitwise_or.reduce(lanes << shifts, axis=1).astype(np.uint32)


def unpack_words(words, length: int) -> np.ndarray:
    """uint32 word layout -> codes 0-3 of ``length``."""
    words = np.asarray(words, dtype=np.uint32)
    shifts = (2 * np.arange(BASES_PER_WORD, dtype=np.uint32))[None, :]
    lanes = (words[:, None] >> shifts) & 3
    return lanes.reshape(-1)[:length].astype(np.uint8)


def ref_bytes_to_words(packed, length: int) -> np.ndarray:
    return pack_words(unpack_ref_bytes(packed, length))


def words_to_ref_bytes(words, length: int) -> np.ndarray:
    return pack_ref_bytes(unpack_words(words, length))


# --- FastA ingestion (fil.cc behavior) ------------------------------------


def fasta_to_text(fasta: str) -> str:
    """Mirror fil.cc:38-57: drop header lines, uppercase A/C/T, map any
    other sequence character (including G itself and N) to 'G',
    and drop whitespace (``inf >> skipws`` skips it)."""
    out = []
    for line in fasta.splitlines():
        if line.startswith(">"):
            continue
        for ch in line:
            if ch.isspace():
                continue
            if ch in "AaCcTt":
                out.append(ch.upper())
            else:
                out.append("G")
    return "".join(out)


def printseq(codes, start: int = 0, length: int | None = None) -> str:
    """Slice of a code sequence as ACGT text (printseq, seqindex.c:354)."""
    codes = np.asarray(codes)
    if length is None:
        length = len(codes) - start
    return decode(codes[start : start + length])


def random_genome(n: int, seed: int = 0) -> str:
    """gen_seq.c equivalent: uniform ACGT text of length ``n``."""
    rng = np.random.default_rng(seed)
    return "".join(np.array(list(NT_CHARS))[rng.integers(0, 4, size=n)])
