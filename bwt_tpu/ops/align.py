"""Gapped-alignment DP: Needleman-Wunsch / pinned variants with the
reference's pseudo-affine scoring, plus a batched anti-diagonal
(wavefront) device fill.

Scoring is bit-exact with smw.c:26-200: match 0, mismatch -6 (read
code 5, 'N', matches everything), gap -3 per base plus -5 to *open* —
"open" meaning the adjacent cell's direction pointer does not already
continue the same gap (smw.c:48-49).  Ties resolve value-first to the
left (genome-skip, 'D'), then up (read-skip, 'I'), then diagonal
(smw.c:55-62).

Two fill paths with identical semantics:

* ``dp_fill`` — tiny numpy fill used by the sequential alignment
  drivers (tail/head/gap stitches are a few dozen bases; host DP beats
  a device dispatch at that size);
* ``dp_fill_diagonals`` — a jitted wavefront over anti-diagonals,
  vectorized across the batch and across each diagonal, for
  device-resident batched alignment (``dp_fill_batch`` is the same
  fill in the conventional matrix layout).

Backtrack (variable-length CIGAR emission) is host-side in both cases,
walking the direction-pointer matrix exactly like smw.c:76-106 /
:154-191.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from bwt_tpu.utils.cigar import Cigar

_NEG = -(1 << 30)


def default_scoring() -> tuple[int, int, int, int]:
    """(match, mismatch, gap_open, gap_extend) from the config layer —
    defaults reproduce smw.c:41-54 (0 / -6 / -5 / -3)."""
    from bwt_tpu.config import DEFAULT

    return DEFAULT.dp_scoring


# --------------------------------------------------------------------------
# Host fill (tiny problems: stitching buffers in the alignment drivers)
# --------------------------------------------------------------------------


def dp_fill(read, genome, scoring=None):
    """DP value + pointer matrices for read (codes 0-3/5) vs genome (0-3).

    Returns (values, pointers), each (len(read)+1, len(genome)+1);
    pointer 0 = diagonal, 1 = up (read skip, 'I'), 2 = left (genome
    skip, 'D'), matching smw.c:38-63.  ``scoring`` = (match, mismatch,
    gap_open, gap_extend); None uses the config defaults.
    """
    sm, sx, go, ge = scoring if scoring is not None else default_scoring()
    read = np.asarray(read, dtype=np.int64)
    genome = np.asarray(genome, dtype=np.int64)
    l1, l2 = len(read), len(genome)
    values = np.zeros((l1 + 1, l2 + 1), dtype=np.int64)
    pointers = np.zeros((l1 + 1, l2 + 1), dtype=np.int8)
    j = np.arange(1, l2 + 1)
    values[0, 1:] = go + ge * j
    pointers[0, 1:] = 2
    i = np.arange(1, l1 + 1)
    values[1:, 0] = go + ge * i
    pointers[1:, 0] = 1
    for i in range(1, l1 + 1):
        rc = read[i - 1]
        match = (rc == 5) | (rc == genome)  # (l2,)
        row_above = values[i - 1]
        ptr_above = pointers[i - 1]
        for jj in range(1, l2 + 1):
            skip2 = 0 if pointers[i, jj - 1] == 2 else go
            skip1 = 0 if ptr_above[jj] == 1 else go
            sdiag = row_above[jj - 1] + (sm if match[jj - 1] else sx)
            sleft = values[i, jj - 1] + ge + skip2
            sup = row_above[jj] + ge + skip1
            v = max(sdiag, sleft, sup)
            values[i, jj] = v
            if v == sleft:
                pointers[i, jj] = 2
            elif v == sup:
                pointers[i, jj] = 1
            else:
                pointers[i, jj] = 0
    return values, pointers


def _backtrack(pointers, i, j, cigar: Cigar, flip: bool) -> None:
    """Walk pointers from (i, j) to a border, pushing I/D/M runs.

    ``flip=True`` reproduces nw_fast's extra stack flip (smw.c:36,
    :107): runs land on ``cigar`` start-of-read-first; ``flip=False``
    is sw_fast's direct push (end-of-read-first, smw.c:156-191).
    """
    s = Cigar() if flip else cigar
    while i and j:
        d = pointers[i, j]
        if d == 1:
            i -= 1
            s.push("I", 1)
        elif d == 2:
            j -= 1
            s.push("D", 1)
        else:
            i -= 1
            j -= 1
            s.push("M", 1)
    if i:
        s.push("I", i)
    if j:
        s.push("D", j)
    if flip:
        s.flip_onto(cigar)


def nw_fast(read, genome, cigar: Cigar, scoring=None) -> int:
    """Free-tail alignment (smw.c:26-111).

    The read is aligned from its start; its last character may land on
    any genome column (best last-row score, first on ties, strict '>'
    scan smw.c:65-70).  Returns that column minus one; pushes CIGAR
    runs onto ``cigar`` (flipped — start-of-read run first).  A
    zero-length read is a no-op returning 0 (smw.c:28-30).
    """
    l1 = len(read)
    if l1 == 0:
        return 0
    values, pointers = dp_fill(read, genome, scoring)
    maxloc = int(np.argmax(values[l1]))  # first max == strict > scan
    _backtrack(pointers, l1, maxloc, cigar, flip=True)
    return maxloc - 1


def sw_fast(read, genome, cigar: Cigar, scoring=None) -> None:
    """Both-ends-pinned alignment (smw.c:117-200): backtrack from
    (len(read), len(genome)), pushing runs directly (no flip)."""
    values, pointers = dp_fill(read, genome, scoring)
    _backtrack(pointers, len(read), len(genome), cigar, flip=False)


def smw_naive(read, genome):
    """The retained naive DP (smw.c:206-242): +2 match, -1 otherwise,
    linear gaps.  Returns the full value matrix."""
    read = np.asarray(read, dtype=np.int64)
    genome = np.asarray(genome, dtype=np.int64)
    l1, l2 = len(read), len(genome)
    v = np.zeros((l1 + 1, l2 + 1), dtype=np.int64)
    v[:, 0] = -np.arange(l1 + 1)
    v[0, :] = -np.arange(l2 + 1)
    for i in range(1, l1 + 1):
        for j in range(1, l2 + 1):
            if read[i - 1] == genome[j - 1]:
                v[i, j] = 2 + v[i - 1, j - 1]
            else:
                v[i, j] = max(v[i, j - 1], v[i - 1, j], v[i - 1, j - 1]) - 1
    return v


# --------------------------------------------------------------------------
# Batched device fill: wavefront over anti-diagonals
# --------------------------------------------------------------------------

# Anti-diagonal steps per loop iteration of the fill and of the
# batch_exec backtrack (lax.scan ``unroll``), by JAX's default backend
# at trace time.  Each GPU loop iteration pays a fixed cost of tens of
# microseconds; on an H100 8 steps per iteration cut the phase-B DP of
# a 32,768-read single_align call 3.2x against 1, every bucket shape
# faster.  XLA:CPU ran the same DP 2.7x slower unrolled, so it keeps 1
# (tools/ab_dp_fill.py --scan-unroll; PERF.md).
DP_SCAN_UNROLL = {"cpu": 1, "gpu": 8}


def dp_scan_unroll() -> int:
    return DP_SCAN_UNROLL.get(jax.default_backend(), 1)


@functools.partial(jax.jit, static_argnames=("scoring",))
def dp_fill_diagonals(reads: jax.Array, genomes: jax.Array, scoring=None):
    """Batched DP fill on device, one anti-diagonal per scan step.

    ``reads`` (B, L1) int32 codes 0-3/5, ``genomes`` (B, L2) int32
    codes 0-3; both zero-padded (cells beyond a pair's true lengths
    are filled but never read).  Returns ``(values, pointers)``, each
    (L1+L2+1, L1+1, B) int32: ``[d, i, b]`` is DP cell (i, d-i) of
    pair b; slots with d-i outside [0, L2] hold garbage.  ``scoring``
    = (match, mismatch, gap_open, gap_extend), static; None uses the
    config defaults.

    Cell (i, j) needs (i-1, j-1) from diagonal d-2 and (i-1, j),
    (i, j-1) from d-1, so the scan carries the two live diagonals and
    reaches every neighbour by a static one-row shift: no dynamic
    gather or scatter.  The genome character of cell (i, d-i) is
    genome[d-1-i], so a carried register shifts one row per step and
    takes genome[d-1] in at row 0.
    """
    MATCH, MISMATCH, GAP_OPEN, GAP_EXTEND = (
        scoring if scoring is not None else default_scoring()
    )
    B, L1 = reads.shape
    _, L2 = genomes.shape
    D = L1 + L2 + 1
    zrow = jnp.zeros((1, B), jnp.int32)
    rvec = jnp.concatenate(
        [zrow, jnp.asarray(reads, jnp.int32).T], axis=0
    )  # rvec[i] = read[i-1]
    ginj = jnp.zeros((D, B), jnp.int32).at[1 : L2 + 1].set(
        jnp.asarray(genomes, jnp.int32).T
    )  # ginj[d] = genome[d-1]
    row = jnp.arange(L1 + 1, dtype=jnp.int32)[:, None]

    def shift(x):
        return jnp.concatenate([zrow, x[:-1]], axis=0)

    def body(carry, xs):
        prev2, prev1, pptr1, gdiag = carry
        d, g = xs
        gdiag = jnp.concatenate([g[None], gdiag[:-1]], axis=0)
        match = (rvec == 5) | (rvec == gdiag)
        sdiag = shift(prev2) + jnp.where(match, MATCH, MISMATCH)
        sleft = prev1 + GAP_EXTEND + jnp.where(pptr1 == 2, 0, GAP_OPEN)
        sup = shift(prev1) + GAP_EXTEND + jnp.where(
            shift(pptr1) == 1, 0, GAP_OPEN)
        v = jnp.maximum(jnp.maximum(sdiag, sleft), sup)
        p = jnp.where(v == sleft, 2, jnp.where(v == sup, 1, 0))
        # borders: DP row 0 (row index 0) and column 0 (row index d)
        v = jnp.where((row == 0) | (row == d), GAP_OPEN + GAP_EXTEND * d, v)
        p = jnp.where(row == 0, 2, jnp.where(row == d, 1, p))
        return (prev1, v, p, gdiag), (v, p)

    zero = jnp.zeros((L1 + 1, B), jnp.int32)  # diagonal 0: cell (0,0) = 0
    _, (vals, ptrs) = jax.lax.scan(
        body, (zero, zero, zero, zero),
        (jnp.arange(1, D, dtype=jnp.int32), ginj[1:]),
        unroll=dp_scan_unroll(),
    )
    return (jnp.concatenate([zero[None], vals]),
            jnp.concatenate([zero[None], ptrs]))


@functools.partial(jax.jit, static_argnames=("scoring",))
def dp_fill_batch(reads: jax.Array, genomes: jax.Array, scoring=None):
    """Batched DP fill on device in the conventional layout.

    Same inputs as :func:`dp_fill_diagonals`; returns ``(values,
    pointers)`` of shape (B, L1+1, L2+1) int32, read out of the
    per-diagonal fill (cell (i, j) sits at diagonal i+j, row i).
    """
    B, L1 = reads.shape
    _, L2 = genomes.shape
    vals_d, ptrs_d = dp_fill_diagonals(reads, genomes, scoring)
    i = jnp.arange(L1 + 1)[:, None]
    j = jnp.arange(L2 + 1)[None, :]
    return (jnp.transpose(vals_d[i + j, i], (2, 0, 1)),
            jnp.transpose(ptrs_d[i + j, i], (2, 0, 1)))


@functools.partial(jax.jit, static_argnames=("scoring",))
def nw_endpos_batch(
    reads: jax.Array,
    read_lens: jax.Array,
    genomes: jax.Array,
    genome_lens: jax.Array,
    scoring=None,
):
    """Batched free-tail endpoints: per pair, the best genome column of
    the read's last row (first max), minus one — nw_fast's return
    value (smw.c:65-70, :110).  Also returns (values, pointers) for
    host backtrack."""
    B, L1 = reads.shape
    _, L2 = genomes.shape
    values, pointers = dp_fill_batch(reads, genomes, scoring)
    last_rows = jnp.take_along_axis(
        values, read_lens[:, None, None], axis=1
    )[:, 0, :]  # (B, L2+1)
    cols = jnp.arange(L2 + 1, dtype=jnp.int32)[None, :]
    masked = jnp.where(cols <= genome_lens[:, None], last_rows, _NEG)
    maxloc = jnp.argmax(masked, axis=1).astype(jnp.int32)
    return maxloc - 1, maxloc, values, pointers


def nw_fast_batch(reads, read_lens, genomes, genome_lens, scoring=None):
    """Batched nw_fast: returns (endpos (B,), cigars list[Cigar]).

    Device wavefront fill, host backtrack.  Zero-length reads yield
    endpos 0 and an empty CIGAR (smw.c:28-30).
    """
    endpos, maxloc, _, pointers = nw_endpos_batch(
        jnp.asarray(reads, jnp.int32),
        jnp.asarray(read_lens, jnp.int32),
        jnp.asarray(genomes, jnp.int32),
        jnp.asarray(genome_lens, jnp.int32),
        scoring,
    )
    endpos = np.asarray(endpos)
    maxloc = np.asarray(maxloc)
    pointers = np.asarray(pointers)
    read_lens = np.asarray(read_lens)
    cigars = []
    out = []
    for b in range(pointers.shape[0]):
        c = Cigar()
        if read_lens[b] == 0:
            out.append(0)
        else:
            _backtrack(pointers[b], int(read_lens[b]), int(maxloc[b]), c, flip=True)
            out.append(int(endpos[b]))
        cigars.append(c)
    return np.asarray(out, np.int32), cigars


def sw_fast_batch(reads, read_lens, genomes, genome_lens, scoring=None):
    """Batched sw_fast: both ends pinned; returns list[Cigar]."""
    _, pointers = dp_fill_batch(
        jnp.asarray(reads, jnp.int32), jnp.asarray(genomes, jnp.int32), scoring
    )
    pointers = np.asarray(pointers)
    read_lens = np.asarray(read_lens)
    genome_lens = np.asarray(genome_lens)
    cigars = []
    for b in range(pointers.shape[0]):
        c = Cigar()
        _backtrack(pointers[b], int(read_lens[b]), int(genome_lens[b]), c, flip=False)
        cigars.append(c)
    return cigars
