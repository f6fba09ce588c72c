"""Batched coroutine executor: bit-exact sequential control flow per
read, device execution fused into one dispatch per round.

The reference's alignment drivers (single_align.c:26-298) are
intrinsically sequential per read — nested retry loops, data-dependent
branches — exactly what an accelerator cannot trace. Rather than
translating that control flow into masked device loops (combinatorial
states), each read runs its driver as a host *generator* that yields
FM-index query requests; this scheduler collects one pending request per
live read each round and executes the whole round as a **single jitted
service dispatch**: every lane carries an opcode (mms / mms_continue /
bsearch / unc_sa / crank) and the fused kernel runs one shared lockstep
LF loop plus the LF-walk and rank adjuncts under per-lane masks. Pattern
bytes live in a device-resident bank uploaded once per run; requests
address (row, offset, length) slices, so no per-round host array packing
happens at all. DP stitches run as batched device wavefront fills with
device backtrack (see :func:`dp_rounds` below). Per-read call sequences
(and therefore outputs) are identical to running each read alone.

Request protocol (generator ``yield`` values; ``row`` is a bank handle
from :meth:`QueryService.add_read`):
  ("mms", row, off, ln)                     -> (matched, sp, ep, pos)
                                               pos = fused unc_sa(sp)
  ("mms_ext", row, off, ln, curpos, curgap) -> (matched, sp, ep, wbest)
                                               wbest = genome position of
                                               the first interval entry
                                               within curgap+3 of curpos
                                               (-1 none); needs
                                               fmi.isa_samples
  ("mms_continue", row, off, ln, sp, ep)    -> (matched, sp, ep)
  ("mms_continue_full", row, off, ln, sp, ep) -> dict incl. the final
                                               (possibly empty) interval
                                               and pos = fused
                                               unc_sa(final start)
  ("bsearch", row, off, ln)                 -> dict of backward_search
                                               results (no N handling);
                                               incl. pos = fused
                                               unc_sa(final start)
  ("bsearch_ext", row, off, ln, wlo, wwid)  -> same + wbest = genome
                                               position of the minimal
                                               final-interval row in
                                               [wlo, wlo+wwid) (-1
                                               none); needs isa_samples
  ("unc_sa", idx)                           -> position
  ("unc_sa_range", start, end)              -> np.array positions [start,end)
  ("isa_range", plo, phi)                   -> np.array of SA rows for
                                               positions [plo,phi), -1 where
                                               out of range (phi-plo <= 32;
                                               needs fmi.isa_samples)
  ("crank", c, idx)                         -> C[c] + rank(c, idx)
  ("nw", row, roff, rlen, rrev, gstart, glen, grev)
                                            -> (endpos, runs) — nw_fast's
                                               endpoint + CIGAR runs in
                                               push order (pre-flip)
  ("sw", row, roff, rlen, rrev, gstart, glen, grev)
                                            -> runs (direct push order)
  ("par", [req, ...])                       -> [reply, ...] — speculative
                                               multi-request: every
                                               sub-request (any op above
                                               except "par") executes in
                                               the SAME round; replies
                                               come back as a list in
                                               order.  Drivers use this
                                               to batch retry chains
                                               whose successive requests
                                               are deterministic (each
                                               retry's parameters depend
                                               only on loop state, not
                                               on the previous reply) —
                                               the host consumes the
                                               reply prefix the
                                               sequential loop would
                                               have issued and discards
                                               the rest.  The service is
                                               stateless per request, so
                                               outputs are identical to
                                               the sequential chain;
                                               only round count (host<->
                                               device round trips) drops.

Generators terminate via ``return value`` (StopIteration).
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from bwt_tpu.index import FMIndex
from bwt_tpu.ops import align as align_ops
from bwt_tpu.ops import rank as rank_ops
from bwt_tpu.ops import search
from bwt_tpu.utils.profiling import span as _span

# service opcodes
OP_NONE, OP_MMS, OP_CONT, OP_BSEARCH, OP_UNC, OP_CRANK = 0, 1, 2, 3, 4, 5
OP_MEXT, OP_BEXT = 6, 7
_OPC = {"mms": OP_MMS, "mms_continue": OP_CONT,
        "mms_continue_full": OP_CONT, "bsearch": OP_BSEARCH,
        "unc_sa": OP_UNC, "crank": OP_CRANK,
        "mms_ext": OP_MEXT, "bsearch_ext": OP_BEXT}

_NEG = -(1 << 30)

# device-side backtrack RLE: runs per lane fetched compactly; lanes
# with more runs (rare — alternating 1-step ops) fall back to fetching
# that bucket's raw ops matrix
# Device-RLE run capacity per DP backtrack.  16 covered the median job
# but ~2% of 32x32 stitch backtracks on 1%-mutated 80-mers exceed it,
# and in the fused phase B every overflow forces a FULL host-generator
# realignment of the lane (measured: 691/32768 lanes = ~0.6 s of the
# 1.8 s end-to-end at 1 Mb).  32 makes overflow vanishingly rare; the
# extra one-hot width costs ~2x on a (jobs, S, R) bool reduce that is
# far off the critical path.
_RLE_R = 40


def _rle_device(ops: jax.Array):
    """Run-length encode each (walk-order) backtrack row ON DEVICE.

    Fetching the raw (B, S) op matrix and RLE-ing it on the host
    (numpy) moves S bytes per lane and runs a host loop per round.
    Emitting (nrun, vals, counts) from the same dispatch makes the
    host's share a tuple-building loop over <= _RLE_R entries.

    Returns (nrun (B,) int16, vals (B, _RLE_R) int8, counts
    (B, _RLE_R) int16) — ~146 B per lane at _RLE_R=48, under the raw
    int8 ops fetch for typical S (>= ~150; small S buckets pay a
    little more, but they are off the hot path); rows with nrun >
    _RLE_R have garbage tails and
    are re-decoded host-side from the raw ops.  Rows whose run count
    or any run length would overflow the narrow dtypes (possible only
    for near-max_read_len reads: S can reach ~1.3x the read length)
    are FORCED onto that same re-decode path by reporting
    nrun = _RLE_R + 1 — the int16 wrap could otherwise go negative and
    silently pass the ``nrun > _RLE_R`` overflow test.  Op 3 = no-op
    filler."""
    B, S = ops.shape
    live = ops != 3
    o32 = ops.astype(jnp.int32)
    prevop = jnp.concatenate(
        [jnp.full((B, 1), -1, jnp.int32), o32[:, :-1]], axis=1
    )
    prevlive = jnp.concatenate(
        [jnp.zeros((B, 1), bool), live[:, :-1]], axis=1
    )
    starts = live & (~prevlive | (o32 != prevop))
    rid = jnp.cumsum(starts.astype(jnp.int32), axis=1)  # 1-based run id
    nrun = rid[:, -1]
    # the one-hot expansion only needs min(_RLE_R, S) run slots — a
    # row of S walk steps can hold at most S runs, and the dominant
    # 16-granule DP buckets have S well under _RLE_R; the tail pads
    # with zeros so callers see the fixed (B, _RLE_R) shape
    Re = min(_RLE_R, S)
    k = jnp.arange(Re, dtype=jnp.int32)[None, None, :]
    sel = rid[:, :, None] == k + 1
    counts = jnp.sum(sel & live[:, :, None], axis=1, dtype=jnp.int32)
    vals = jnp.sum(
        jnp.where(sel & starts[:, :, None], o32[:, :, None], 0),
        axis=1, dtype=jnp.int32,
    )
    if Re < _RLE_R:
        pad = jnp.zeros((B, _RLE_R - Re), jnp.int32)
        counts = jnp.concatenate([counts, pad], axis=1)
        vals = jnp.concatenate([vals, pad], axis=1)
    over = (nrun > 32000) | (jnp.max(counts, axis=1) > 32000)
    nrun = jnp.where(over, jnp.int32(_RLE_R + 1), jnp.minimum(nrun, 32000))
    return (nrun.astype(jnp.int16), vals.astype(jnp.int8),
            counts.astype(jnp.int16))


def _pow2(n: int, floor: int = 8) -> int:
    n = max(n, floor)
    return 1 << (n - 1).bit_length()


def _pad16(n: int, floor: int = 16) -> int:
    return max(floor, -(-n // 16) * 16)


@functools.partial(jax.jit, static_argnames=("Lb", "bits"))
def _unpack_bank(packed: jax.Array, Lb: int, bits: int) -> jax.Array:
    """Device-side unpack of the bank upload: ``packed`` (R, Lb*bits/32)
    uint32, little-endian ``bits``-bit lanes along axis 1 -> (R, Lb)
    int32.  bits=2 for pure-ACGT banks, 4 when any read carries an N
    (code 5)."""
    per = 32 // bits
    w = jnp.repeat(packed, per, axis=1)[:, :Lb]
    shift = ((jnp.arange(Lb, dtype=jnp.uint32) % per)
             * jnp.uint32(bits))
    return ((w >> shift[None, :]) & ((1 << bits) - 1)).astype(jnp.int32)


def _pack_bank_host(mat: np.ndarray, bits: int) -> np.ndarray:
    """Host-side pack for :func:`_unpack_bank` (strided-OR passes, the
    same recipe as index._pack16_host).  ``mat`` (R, Lb) uint8 codes,
    Lb % 16 == 0."""
    if bits == 2:
        b = (mat[:, 0::4] | (mat[:, 1::4] << 2)
             | (mat[:, 2::4] << 4) | (mat[:, 3::4] << 6))
    else:
        b = mat[:, 0::2] | (mat[:, 1::2] << 4)
    return np.ascontiguousarray(b).view(np.uint32)


class _LazyRowViews(list):
    """A list of per-read bank-row views whose elements materialize on
    first access.  add_reads_batch installs one per batch;
    ``len()`` answers without materializing (add_reads_batch's
    empty-bank check and add_read's handle math only need the count).
    Any element access, iteration, or mutation first fills the list
    from the (rows, lens, stride) source."""

    def __init__(self, rows, lens, stride):
        super().__init__()
        self._src = (rows, lens, stride)

    def _fill(self):
        if self._src is not None:
            rows, lens, stride = self._src
            self._src = None
            super().extend(
                rows[k, : lens[k // stride]] for k in range(rows.shape[0])
            )
        return self

    def __len__(self):
        if self._src is not None:
            return self._src[0].shape[0]
        return super().__len__()

    def __iter__(self):
        return super(_LazyRowViews, self._fill()).__iter__()

    def __getitem__(self, i):
        return super(_LazyRowViews, self._fill()).__getitem__(i)

    def append(self, x):
        super(_LazyRowViews, self._fill()).append(x)

    def extend(self, xs):
        super(_LazyRowViews, self._fill()).extend(xs)


def dp_shape(rlen, glen):
    """Jit-signature shape bucket for one DP job: each dim padded to a
    multiple of 32 with a floor of 32.  THE single shape policy for
    every DP dispatch path (executor buckets, :func:`dp_jobs_blocks`,
    the aligner's fused phase B) — diverging policies would double the
    compile-signature set."""
    return (max(32, -(-int(rlen) // 32) * 32),
            max(32, -(-int(glen) // 32) * 32))


def dp_shapes(rlen, glen):
    """Vectorized :func:`dp_shape` over numpy arrays."""
    rl = np.asarray(rlen, np.int64)
    gl = np.asarray(glen, np.int64)
    return (np.maximum(32, -(-rl // 32) * 32),
            np.maximum(32, -(-gl // 32) * 32))


# --------------------------------------------------------------------------
# The fused service kernel
# --------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("resolve", "ext"))
def _service_step(
    fmi: FMIndex,
    bank: jax.Array,
    opc: jax.Array,
    row: jax.Array,
    off: jax.Array,
    ln: jax.Array,
    sp: jax.Array,
    ep: jax.Array,
    idx: jax.Array,
    *,
    resolve: bool,
    ext: bool = False,
):
    """Jitted per-round wrapper over :func:`_service_core` (the
    executor's one-dispatch-per-round entry point)."""
    return _service_core(
        fmi, bank, opc, row, off, ln, sp, ep, idx,
        resolve=resolve, ext=ext,
    )


# unc_sa's wide-batch compaction ladder inside the fused service round:
# ON by default (the automatons' walk has the same geometric-max
# padding as the standalone walk); env-driven so A/B runs compare
# fresh processes (the flag is baked in at trace time, not a jit key)
_SERVICE_UNC_LADDER = os.environ.get("BWT_SERVICE_UNC_LADDER", "1") != "0"


def _service_core(
    fmi: FMIndex,
    bank: jax.Array,   # (R, Lb) int32 pattern bank
    opc: jax.Array,    # (B,) int32 opcodes
    row: jax.Array,    # (B,) bank row
    off: jax.Array,    # (B,) slice offset
    ln: jax.Array,     # (B,) slice length (mms/cont/bsearch); c for crank
    sp: jax.Array,     # (B,) incoming interval start (cont); c for crank;
                       #      curpos (mms_ext); window lo (bsearch_ext)
    ep: jax.Array,     # (B,) incoming interval end (cont); curgap
                       #      (mms_ext); window width (bsearch_ext)
    idx: jax.Array,    # (B,) index operand (unc_sa walk / crank rank)
    *,
    resolve: bool,
    ext: bool = False,
    with_crank: bool = True,
    full_steps: bool = False,
    seed_rows=None,    # (4^seed_k, 6) int32 SeedTable rows, or None
    seed_k: int = 0,
    spec_anch: int = 0,   # speculative OP_MMS anchor retries per round
    anchor_len: int = 0,  # static accept threshold for the retries
    am=None,              # (B,) anchmisses budget (spec_anch > 0 only)
):
    """One fused round: the shared lockstep LF loop (mms semantics of
    seqindex.c:314-351, mms_continue of single_align.c:26-46 and raw
    backward search under per-lane masks), the unc_sa LF walk
    (seqindex.c:244-255) and C[c]+rank adjuncts — one dispatch, one
    download.  ``resolve`` statically gates the N-resolution gathers
    (seqindex.c:330-340); rounds whose reads are N-free skip them.

    Every loop lane also speculatively answers the unc_sa its caller
    would ask next (mms lanes walk from the match interval's start,
    bsearch/cont lanes from the FINAL — possibly empty — interval's
    start, the drivers' quirk value): the LF-walk unit runs for all
    lanes regardless, so the fusion is free and saves its round trip.

    ``ext`` statically gates the fused inverse-SA window scan for the
    OP_MEXT / OP_BEXT opcodes: the drivers' "which interval entry lies
    near position X?" candidate scan (single_align.c:218-223,
    rnaseqtest.c:110-121) answered in the same dispatch as the mms /
    backward search that precedes it (requires fmi.isa_samples); at
    runtime a ``lax.cond`` skips the scan when no lane carries an ext
    opcode (device automatons call the core every iteration with
    ``ext=True`` but only occasionally have ext lanes).

    Plain traceable function (not jitted): the per-round executor jits
    it via :func:`_service_step`; the device-resident driver automatons
    (models/rnaseq.rna_seq_device) call it inside a ``lax.while_loop``
    body.  ``with_crank`` statically drops the C[c]+rank adjunct for
    callers that never issue OP_CRANK.

    ``seed_rows``/``seed_k``: mms/bsearch lanes whose effective length
    is >= seed_k (and, under ``resolve``, with no N among the first
    seed_k processed characters) initialize from the precomputed
    backward-search state table (ops/search.SeedTable — one row-gather
    answers the first seed_k steps, including the emptied-early case)
    and enter the LF loop with a per-lane step shift, so the loop's
    trip count drops by ~seed_k.  Bit-exact by the table's
    construction; lanes that cannot seed run unshifted.

    ``spec_anch``/``anchor_len``/``am``: speculative anchor-retry
    chains for OP_MMS lanes (the aligner automaton's ANCH phase).
    single_align.c:174-189 retries a missed anchor at ln-3 with the
    anchmisses budget decremented; issuing each retry as its own
    automaton round pays the round's fixed costs (unc_sa walk, ISA
    scan, phase machine) per attempt.  With ``spec_anch`` = S > 0, a
    round runs up to S attempts of the EXACT C retry sequence inside
    this dispatch — per-lane (ln, am) step down by (3, 1) between
    attempts, stopping at the first accepted anchor (seglen >=
    anchor_len and interval width 1) or when the C loop would stop —
    and two extra outputs carry the final attempt's (ln, am) so the
    automaton's phase math continues exactly where the C loop's state
    would be.  Lanes still missing after S attempts simply continue
    next round (the chain is a pure batching of rounds)."""
    B = opc.shape[0]
    Lb = bank.shape[1]
    is_mms = (opc == OP_MMS) | (opc == OP_MEXT)
    is_cont = opc == OP_CONT
    is_bs = (opc == OP_BSEARCH) | (opc == OP_BEXT)
    in_loop = is_mms | is_cont | is_bs

    pats = jnp.take(bank, row, axis=0)  # (B, Lb)

    # step index of column p in the reverse walk: step 0 processes
    # column off+ln-1, step j column off+ln-1-j.  All prep below works
    # in COLUMN space with arithmetic one-hots — the former explicit
    # reversed-gather (take_along_axis over the full (B, Lb) window)
    # was ~2.6 M gathered elements per automaton round at 32 k lanes,
    # the largest fixed per-round device cost.
    pos = jnp.arange(Lb, dtype=jnp.int32)[None, :]
    resolve_lane = is_mms | is_cont  # bsearch never resolves N

    def lf_search(ln_v, active0):
        """One full lockstep search pass over pattern[off : off+ln_v]
        for the ``in_loop`` lanes selected by ``active0`` — trailing-N
        strip, seed-table jump, and the masked LF loop.  Returns
        (start, end, osp, oep, nmatched, alive, skips,
        incoming_empty)."""
        j_of_p = off[:, None] + ln_v[:, None] - 1 - pos  # (B, Lb)
        in_read = (j_of_p >= 0) & (j_of_p < ln_v[:, None])

        # trailing-N strip for mms lanes (seqindex.c:317-320),
        # slice-aware: skips = first step with a non-N char (= ln when
        # all-N); clamped at 0 for the pinned ln <= 0 UB lanes
        if resolve:
            nonn = (pats != 5) & in_read
            first_nonn = jnp.min(
                jnp.where(nonn, j_of_p, jnp.int32(0x7FFFFFFF)), axis=1
            )
            skips = jnp.where(
                is_mms, jnp.maximum(jnp.minimum(first_nonn, ln_v), 0), 0)
        else:
            skips = jnp.zeros((B,), jnp.int32)

        # effective step count: mms strips trailing N (min 1); bsearch
        # runs ln raw (min 1); mms_continue processes all ln chars but
        # has no initial-character step, modeled as eff = ln + 1 with
        # step 1 touching char ln-1 (single_align.c:31-44).
        eff = jnp.where(
            is_cont,
            ln_v + 1,
            jnp.maximum(jnp.where(is_mms, ln_v - skips, ln_v), 1),
        )

        if seed_rows is not None:
            # seed-table jump: chars processed at steps 0..k-1 live at
            # window steps skips..skips+k-1 (bsearch: skips == 0); the
            # state overrides apply after the unseeded init below, and
            # seeded lanes enter the loop shifted by tsh = seed_k - 1.
            # The key builds as a one-hot weighted reduction over
            # columns (wj = window step of column p) — no gathers.
            can_seed = (is_mms | is_bs) & (ln_v > 0) & (eff >= seed_k) \
                & active0
            wj = j_of_p - skips[:, None]
            inw = (wj >= 0) & (wj < seed_k) & in_read
            if resolve:
                can_seed = can_seed & ~jnp.any(inw & (pats == 5), axis=1)
            wts = jnp.where(
                inw, jnp.int32(1) << (2 * jnp.clip(wj, 0, 15)), 0)
            key = jnp.sum(pats * wts, axis=1, dtype=jnp.int32)
            srow = jnp.take(seed_rows, jnp.where(can_seed, key, 0), axis=0)
            tsh = jnp.where(can_seed, jnp.int32(seed_k - 1), 0)
        else:
            tsh = jnp.zeros((B,), jnp.int32)

        def char_at(t):
            ci = jnp.clip(off + eff - 1 - t - tsh, 0, Lb - 1)
            if Lb <= 128:
                oh = jnp.arange(Lb, dtype=jnp.int32) == ci[:, None]
                return jnp.sum(pats * oh, axis=1, dtype=jnp.int32)
            return jnp.take_along_axis(pats, ci[:, None], axis=1)[:, 0]

        # initial state
        c0 = char_at(jnp.int32(0))
        # mms/bsearch with ln <= 0 is reference-UB (seqindex.c:314
        # reads pattern[len-1] out of bounds); we pin the round-1
        # executor's defined behavior — the search sees character 'A'
        # (the zeroed pattern row), the masked loop takes no steps
        c0 = jnp.where((is_mms | is_bs) & (ln_v <= 0), 0, c0)
        if resolve:
            # a fully-N mms read leaves c0 == 5; the reference reads
            # C[5]/C[6] out of bounds (UB) — we clamp to 'A'
            c0 = jnp.where(is_mms & (c0 == 5), 0, c0)
        start0 = search.take_c(fmi.C, c0)
        end0 = search.take_c(fmi.C, c0 + 1)
        start = jnp.where(is_cont, sp, start0)
        end = jnp.where(is_cont, ep, end0)
        alive = end > start
        incoming_empty = is_cont & ~alive
        nmatched = (alive & ~is_cont).astype(jnp.int32)
        osp, oep = start, end

        if seed_rows is not None:
            start = jnp.where(can_seed, srow[:, 0], start)
            end = jnp.where(can_seed, srow[:, 1], end)
            osp = jnp.where(can_seed, srow[:, 2], osp)
            oep = jnp.where(can_seed, srow[:, 3], oep)
            nmatched = jnp.where(can_seed, srow[:, 4], nmatched)
            alive = jnp.where(can_seed, srow[:, 5] > 0, alive)

        steps = jnp.max(jnp.where(in_loop & active0, eff - tsh, 0))

        def lf_cond(state):
            # early exit once every lane is dead or past its own eff:
            # all remaining steps would be fully-masked no-ops (alive
            # only decreases, eff is fixed), so outputs are
            # bit-identical.  ``full_steps`` (tests only) disables the
            # exit so the equivalence is pinned directly
            # (tests/test_service_fuzz.py::test_early_exit_equivalence)
            t, _, _, _, _, _, alive = state
            if full_steps:
                return t < steps
            return (t < steps) & jnp.any(
                alive & (t + tsh <= eff - 1) & in_loop & active0
            )

        def body(state):
            t, start, end, osp, oep, nmatched, alive = state
            active = alive & (t + tsh <= eff - 1) & in_loop & active0
            c = char_at(t)
            if resolve:
                c, ns, ne = search._resolve_step(fmi, c, start, end,
                                                 resolve_lane)
            else:
                ns, ne = search._step(fmi, c, start, end)
            ok = ne > ns
            start = jnp.where(active, ns, start)
            end = jnp.where(active, ne, end)
            upd = active & ok
            osp = jnp.where(upd, ns, osp)
            oep = jnp.where(upd, ne, oep)
            nmatched = nmatched + upd.astype(jnp.int32)
            alive = alive & (~active | ok)
            return t + 1, start, end, osp, oep, nmatched, alive

        (_, start, end, osp, oep, nmatched, alive) = jax.lax.while_loop(
            lf_cond, body,
            (jnp.int32(1), start, end, osp, oep, nmatched, alive),
        )
        return (start, end, osp, oep, nmatched, alive, skips,
                incoming_empty)

    all_on = jnp.ones((B,), bool)
    if not spec_anch:
        (start, end, osp, oep, nmatched, alive, skips,
         incoming_empty) = lf_search(ln, all_on)
        ln_fin, am_fin = ln, am
    else:
        spec_lane = opc == OP_MMS

        def attempt(s, carry):
            ln_c, am_c, done, res = carry
            active = jnp.where(spec_lane, ~done, s == 0)
            outs = lf_search(ln_c, active)
            res = tuple(
                jnp.where(active, o, p) for o, p in zip(outs, res)
            )
            _, _, osp_s, oep_s, nm_s, _, sk_s, _ = outs
            seglen = nm_s + sk_s
            # the C retry decision (single_align.c:176-181): miss ->
            # keep hunting while ln - 3 > anchor_len and budget holds
            miss = (seglen < anchor_len) | (oep_s - osp_s > 1)
            hunt = (ln_c - 3 > anchor_len) & (am_c - 1 > 0)
            will_retry = spec_lane & active & miss & hunt
            done = done | (spec_lane & active & ~(miss & hunt))
            # decrement only when another attempt actually runs here;
            # a lane still missing at the last attempt hands (ln, am)
            # back unchanged and the automaton's own retry math takes
            # over (pure batching of rounds)
            dec = will_retry & (s < spec_anch - 1)
            return (jnp.where(dec, ln_c - 3, ln_c),
                    jnp.where(dec, am_c - 1, am_c), done, res)

        zi = jnp.zeros((B,), jnp.int32)
        zb = jnp.zeros((B,), bool)
        init = (ln, am, jnp.zeros((B,), bool),
                (zi, zi, zi, zi, zi, zb, zi, zb))
        ln_fin, am_fin, _, res = jax.lax.fori_loop(
            0, spec_anch, attempt, init)
        (start, end, osp, oep, nmatched, alive, skips,
         incoming_empty) = res

    matched_mms = nmatched + skips
    matched_cont = nmatched - incoming_empty.astype(jnp.int32)

    # unc_sa LF walk — the walk runs for every lane anyway, so loop
    # lanes get their caller's next unc_sa for free: mms lanes locate
    # the match interval's start (osp), bsearch/cont lanes the final
    # interval's start (the drivers read unc_sa(start) even when the
    # interval emptied — rnaseqtest.c:55/:67's quirk value).  OP_MEXT
    # lanes start at 0 (walk done immediately): no mms_ext consumer
    # reads the _POS column (_OP_COLS; the aligner's EXT phase uses
    # _WBEST), and rounds whose lanes are all ext/unc then skip the
    # walk's LF trips entirely.
    walk0 = jnp.where(
        opc == OP_UNC, idx,
        jnp.where(opc == OP_MMS, osp,
                  jnp.where(is_cont | is_bs, start, 0)),
    )

    # fused inverse-SA window scan (OP_MEXT / OP_BEXT lanes)
    if ext:
        W = 32
        m_ext = opc == OP_MEXT
        b_ext = opc == OP_BEXT
        any_ext = m_ext | b_ext
        mm = nmatched + skips
        # mms_ext: |pos + seglen - curpos| <= curgap + 3 as a window
        # [curpos - seglen - (curgap+3), +2*(curgap+3)+1) over the mms
        # result interval [osp, oep) (single_align.c:218-223).
        # bsearch_ext: caller-provided [lo, lo+width) over the final
        # interval [start, end) (rnaseqtest.c:110-121).
        wlo = jnp.where(m_ext, sp - mm - (ep + 3), sp)
        wwid = jnp.where(m_ext, 2 * (ep + 3) + 1, ep)
        wwid = jnp.where(any_ext, jnp.clip(wwid, 0, W), 0)

        if fmi.tp_axis is None:
            # the walk's ~sa_rate LF fetches only serve lanes whose
            # opcode consumes _POS (OP_MEXT reads _WBEST instead) —
            # automaton rounds in pure EXT/HEAD phases skip it
            consumes_pos = (opc == OP_MMS) | is_cont | is_bs | \
                (opc == OP_UNC)
            pos_out = jax.lax.cond(
                jnp.any(consumes_pos),
                lambda _: search.unc_sa(fmi, walk0,
                                        ladder=_SERVICE_UNC_LADDER),
                lambda _: jnp.zeros((B,), jnp.int32), 0)

            def _scan(_):
                return search.isa_window(fmi, wlo, wwid, W=W)

            def _no_scan(_):
                return jnp.full((B, W), -1, jnp.int32)

            # skip the scan's (sa_rate-1)+W LF steps on rounds with no
            # ext lane (the automatons pass ext=True every iteration)
            rows = jax.lax.cond(jnp.any(any_ext), _scan, _no_scan, 0)
        else:
            # tp-sharded: the walk and the scan MUST be one sequential
            # collective chain (see search.walk_and_window_tp) — as
            # independent programs their same-channel psums execute
            # concurrently on XLA:CPU and collide in the rendezvous
            pos_out, rows = search.walk_and_window_tp(
                fmi, walk0, wlo, wwid, W=W
            )
        ilo = jnp.where(m_ext, osp, start)[:, None]
        ihi = jnp.where(m_ext, oep, end)[:, None]
        valid = (rows >= ilo) & (rows < ihi) & (rows >= 0)
        # minimal in-interval row == the first entry the reference's
        # sequential SA-row scan would accept (ops/search.isa_window)
        key = jnp.where(valid, rows, jnp.int32(0x7FFFFFFF))
        j = jnp.argmin(key, axis=1).astype(jnp.int32)
        has = jnp.take_along_axis(valid, j[:, None], axis=1)[:, 0]
        wbest = jnp.where(has & any_ext, wlo + j, -1)
        # the winning SA row itself (rnaseq narrows its interval)
        wrow = jnp.where(
            has & any_ext,
            jnp.take_along_axis(rows, j[:, None], axis=1)[:, 0], -1,
        )
    else:
        pos_out = search.unc_sa(fmi, walk0, ladder=_SERVICE_UNC_LADDER)
        wbest = jnp.full((B,), -1, jnp.int32)
        wrow = wbest

    if with_crank:
        # crank: C[c] + rank(c, idx) with c in the sp field
        c_arg = jnp.clip(jnp.where(opc == OP_CRANK, sp, 0), 0, 4)
        i_arg = jnp.where(opc == OP_CRANK, idx, 0)
        if fmi.tp_axis is not None:
            # chain this psum behind the walk's: pos_out >= 0 always
            # (unc_sa wraps into [0, length]), so adding min(pos_out, 0)
            # is a no-op at runtime that XLA cannot fold away — a real
            # data dependency (optimization_barrier is erased by the
            # CPU pipeline before thunk emission and does NOT order
            # collectives; see search.walk_and_window_tp)
            i_arg = i_arg + jnp.minimum(pos_out, 0)
        crank = search.take_c(fmi.C, c_arg) + rank_ops.rank(
            fmi.buckets, fmi.endloc, c_arg, i_arg, tp_axis=fmi.tp_axis,
            nrows=fmi.bucket_rows,
        )
    else:
        crank = jnp.zeros((B,), jnp.int32)

    # separate (B,) result columns (not a stacked (B, 13)): the
    # executor fetches ONLY the columns the round's opcodes consume —
    # a typical aligner round reads 5-6 of 13 (see _collect_round)
    out = (matched_mms, matched_cont, start, end, osp, oep, nmatched,
           alive.astype(jnp.int32), skips, pos_out, crank, wbest, wrow)
    if spec_anch:
        # the final attempt's (ln, am) so the caller's phase math
        # continues from the C loop's exact state
        out = out + (ln_fin, am_fin)
    return out


(_MMS_M, _CONT_M, _START, _END, _OSP, _OEP, _NM, _ALIVE, _SKIPS,
 _POS, _CRANK, _WBEST, _WROW) = range(13)

# result columns each opcode's reply consumes (_finish_service)
_OP_COLS = {
    "mms": (_MMS_M, _OSP, _OEP, _POS),
    "mms_ext": (_MMS_M, _OSP, _OEP, _WBEST),
    "mms_continue": (_CONT_M, _OSP, _OEP),
    "mms_continue_full": (
        _CONT_M, _OSP, _OEP, _START, _END, _NM, _ALIVE, _POS),
    # plain bsearch never consumes the window-scan outputs (wbest/wrow
    # are constant -1 without OP_BEXT) — fetching them would waste ~20%
    # of the round's fetch bandwidth on the dominant rnaseq opcode
    "bsearch": (_START, _END, _OSP, _OEP, _NM, _ALIVE, _SKIPS, _POS),
    "bsearch_ext": (_START, _END, _OSP, _OEP, _NM, _ALIVE, _SKIPS, _POS,
                    _WBEST, _WROW),
    "unc_sa": (_POS,),
    "crank": (_CRANK,),
}


# --------------------------------------------------------------------------
# Batched DP service (tail/head/gap stitches)
# --------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("L1", "L2", "scoring"))
def _dp_step(
    bank: jax.Array,     # (R, Lb) int32
    genome: jax.Array,   # (G,) int32 genome codes
    row, roff, rlen, rrev, gstart, glen, grev, want_nw,
    L1: int, L2: int, scoring=None,
):
    """Jitted wrapper over :func:`_dp_core` (the executor's per-round
    DP entry point)."""
    return _dp_core(
        bank, genome, row, roff, rlen, rrev, gstart, glen, grev,
        want_nw, L1=L1, L2=L2, scoring=scoring,
    )


def _dp_core(
    bank: jax.Array,     # (R, Lb) int32
    genome: jax.Array,   # (G,) int32 genome codes
    row, roff, rlen, rrev, gstart, glen, grev, want_nw,
    *, L1: int, L2: int, scoring=None,
):
    """Batched NW/SW stitch: gather read/genome slices (either
    reversed — the head alignment reverses both, single_align.c:256-272),
    wavefront DP fill (smw.c:42-64 scoring), nw endpoint scan
    (smw.c:65-70), device backtrack emitting one op per anti-diagonal,
    and device RLE of the op rows (:func:`_rle_device`).
    Returns (maxloc, i_resid, j_resid, nrun, vals, counts, ops): the
    host turns the compact runs into CIGAR tuples and appends the I/D
    residuals (smw.c:99-104); ``ops`` is only fetched for the rare
    lanes whose run count exceeds _RLE_R."""
    Lb = bank.shape[1]
    k1 = jnp.arange(L1, dtype=jnp.int32)[None, :]
    ridx = jnp.where(rrev[:, None] == 1,
                     roff[:, None] + rlen[:, None] - 1 - k1,
                     roff[:, None] + k1)
    reads = jnp.take_along_axis(
        jnp.take(bank, row, axis=0), jnp.clip(ridx, 0, Lb - 1), axis=1
    )
    reads = jnp.where(k1 < rlen[:, None], reads, 0)
    k2 = jnp.arange(L2, dtype=jnp.int32)[None, :]
    gidx = jnp.where(grev[:, None] == 1,
                     gstart[:, None] + glen[:, None] - 1 - k2,
                     gstart[:, None] + k2)
    genomes = jnp.take(genome, jnp.clip(gidx, 0, genome.shape[0] - 1))
    genomes = jnp.where(k2 < glen[:, None], genomes, 0)

    i0 = jnp.clip(rlen, 0, L1)
    # the fill's (D, L1+1, B) diagonal layout is consumed by streaming
    # passes: the backtrack visits at most one cell per anti-diagonal,
    # so a scan over diagonal slabs reads each slab once instead of
    # gathering one cell per lane per step
    vals_d, ptrs_d = align_ops.dp_fill_diagonals(reads, genomes, scoring)
    D, LANES, _ = vals_d.shape
    iota = jnp.arange(LANES, dtype=jnp.int32)[:, None]

    def sel(slab, i):
        """slab (LANES, B) at row i (B,) — one-hot, no gather."""
        return jnp.sum(slab * (iota == i[None, :]), axis=0)

    # nw endpoint — the strict '>' first-max over row i0 (smw.c:65-70),
    # whose cells appear one per diagonal at j = d - i0.  Vectorized
    # over the whole value block: "first strict max of the walk" ==
    # "first occurrence of the maximum", which is argmax's tie rule.
    rowv = jnp.sum(
        vals_d * (iota[None] == i0[None, None, :]),
        axis=1, dtype=vals_d.dtype,
    )  # (D, B): value at (i0, d - i0)
    dd = jnp.arange(D, dtype=jnp.int32)[:, None]
    jcol = dd - i0[None, :]
    validj = (jcol >= 0) & (jcol <= jnp.minimum(glen, L2)[None, :])
    maskedv = jnp.where(validj, rowv, _NEG)
    dstar = jnp.argmax(maskedv, axis=0).astype(jnp.int32)
    maxloc = jnp.where(jnp.any(validj, axis=0), dstar - i0, 0)
    j0 = jnp.where(want_nw == 1, maxloc, jnp.clip(glen, 0, L2))

    # descending d: walk the pointers; emit one op (3 = none) per
    # diagonal.  reverse=True stacks outputs in ascending-d order, so
    # the rows are flipped into walk order below.
    def fwalk(carry, slab):
        d, i, j = carry
        on = (i + j == d) & (i > 0) & (j > 0)
        p = sel(slab, i)
        op = jnp.where(on, jnp.where(p == 1, 1, jnp.where(p == 2, 2, 0)), 3)
        di = (on & ((op == 0) | (op == 1))).astype(jnp.int32)
        dj = (on & ((op == 0) | (op == 2))).astype(jnp.int32)
        return (d - 1, i - di, j - dj), op.astype(jnp.int8)

    (_, i, j), ops = jax.lax.scan(
        fwalk, (jnp.int32(D - 1), i0, j0), ptrs_d, reverse=True,
        unroll=align_ops.dp_scan_unroll(),
    )
    ops = ops.T[:, ::-1]  # (D, B) ascending-d -> (B, D) walk order
    return maxloc, i, j, *_rle_device(ops), ops


def _dp_blocks_core(maxloc, i_res, j_res, nrun, vals, counts, flip):
    """Device-side form of the host run-block builder in
    :func:`dp_jobs_blocks`: per DP job, the RLE runs in push order with
    the I/D border residuals appended (smw.c:99-104) and NW/HEAD blocks
    reversed (the Cigar flip, stack.c:51-59).  Returns
    (bo (J, _RLE_R+2) int32 op codes / -1 padding,
     bc (J, _RLE_R+2) int32 run lengths,
     bl (J,) int32 valid runs,
     over (J,) bool — device-RLE overflow (> _RLE_R runs); such jobs
     cannot compose on device and force their read onto the
     host-generator fallback path)."""
    J = nrun.shape[0]
    W = _RLE_R + 2
    t = jnp.arange(W, dtype=jnp.int32)[None, :]
    nr = jnp.minimum(nrun.astype(jnp.int32), _RLE_R)
    over = nrun.astype(jnp.int32) > _RLE_R
    pad_o = jnp.full((J, 2), -1, jnp.int32)
    pad_c = jnp.zeros((J, 2), jnp.int32)
    bo = jnp.where(t < nr[:, None],
                   jnp.concatenate([vals.astype(jnp.int32), pad_o], 1), -1)
    bc = jnp.where(t < nr[:, None],
                   jnp.concatenate([counts.astype(jnp.int32), pad_c], 1), 0)
    has_i = i_res > 0
    mi = (t == nr[:, None]) & has_i[:, None]
    bo = jnp.where(mi, 1, bo)
    bc = jnp.where(mi, i_res[:, None].astype(jnp.int32), bc)
    cd = nr + has_i
    has_j = j_res > 0
    mj = (t == cd[:, None]) & has_j[:, None]
    bo = jnp.where(mj, 2, bo)
    bc = jnp.where(mj, j_res[:, None].astype(jnp.int32), bc)
    bl = cd + has_j
    idx = jnp.where(flip[:, None] & (t < bl[:, None]),
                    jnp.maximum(bl[:, None] - 1 - t, 0), t)
    bo = jnp.take_along_axis(bo, idx, 1)
    bc = jnp.take_along_axis(bc, idx, 1)
    return bo, bc, bl, over


_OP_CHARS = ("M", "I", "D")


def dp_jobs_blocks(svc, row, roff, rlen, rrev, gstart, glen, grev,
                   want_nw):
    """Run a flat array of DP jobs (one _dp_step dispatch per padded
    shape bucket, exactly like the executor's :meth:`_start_dp`) and
    return per-job results as ARRAYS instead of Python run lists —
    the vectorized phase-B path of the aligner automaton:

      endpos  (J,)  int32 — nw endpoint scan result minus 1 (the
                    executor's reply convention for "nw")
      blk_ops (J, W) int8  — run op codes 0/1/2 in push order,
                    I/D border residuals appended (smw.c:99-104),
                    -1 padding
      blk_cnt (J, W) int32 — run lengths
      blk_len (J,)  int32 — valid runs per job

    W adapts to the rare RLE-overflow rows (> _RLE_R device runs),
    which are decoded from the raw backtrack matrix host-side."""
    J = len(row)
    bank = svc._ensure_bank()
    shapes = [dp_shape(rlen[j], glen[j]) for j in range(J)]
    buckets: dict[tuple[int, int], list[int]] = {}
    for j, s in enumerate(shapes):
        buckets.setdefault(s, []).append(j)

    pend = []
    for (L1, L2), members in buckets.items():
        B = _pow2(len(members))
        f = np.zeros((8, B), np.int32)
        m = np.asarray(members)
        f[0, : len(m)] = row[m]
        f[1, : len(m)] = roff[m]
        f[2, : len(m)] = rlen[m]
        f[3, : len(m)] = rrev[m]
        f[4, : len(m)] = gstart[m]
        f[5, : len(m)] = glen[m]
        f[6, : len(m)] = grev[m]
        f[7, : len(m)] = want_nw[m]
        out = _dp_step(
            bank, svc.genome_dev,
            *(jnp.asarray(f[k]) for k in range(8)), L1=L1, L2=L2,
            scoring=svc.scoring,
        )
        for d in out[:6]:
            try:
                d.copy_to_host_async()
            except (AttributeError, NotImplementedError):  # pragma: no cover
                pass
        pend.append((out, m))

    # width: device RLE window + the two border residuals, grown for
    # overflow rows
    W = _RLE_R + 2
    host = []
    for out, m in pend:
        h = [np.asarray(x) for x in jax.device_get(out[:6])]
        nmax = int(h[3][: len(m)].max(initial=0))
        if nmax > _RLE_R:
            W = max(W, nmax + 2)
        host.append((h, out[6], m))

    endpos = np.zeros(J, np.int32)
    blk_ops = np.full((J, W), -1, np.int8)
    blk_cnt = np.zeros((J, W), np.int32)
    blk_len = np.zeros(J, np.int32)
    t = np.arange(_RLE_R)
    for (maxloc, i_res, j_res, nrun, vals, counts), ops_dev, m in host:
        B = len(m)
        nr = np.minimum(nrun[:B].astype(np.int32), _RLE_R)
        valid = t[None, :] < nr[:, None]
        bo = np.full((B, W), -1, np.int8)
        bc = np.zeros((B, W), np.int32)
        bo[:, :_RLE_R] = np.where(valid, vals[:B], -1)
        bc[:, :_RLE_R] = np.where(valid, counts[:B], 0)
        rows = np.arange(B)
        has_i = i_res[:B] > 0
        bo[rows[has_i], nr[has_i]] = 1
        bc[rows[has_i], nr[has_i]] = i_res[:B][has_i]
        cd = nr + has_i
        has_j = j_res[:B] > 0
        bo[rows[has_j], cd[has_j]] = 2
        bc[rows[has_j], cd[has_j]] = j_res[:B][has_j]
        bl = nr + has_i + has_j
        over = np.nonzero(nrun[:B] > _RLE_R)[0]
        if over.size:
            ops_np = np.asarray(ops_dev)
            for k in over:
                runs = _ops_to_runs(ops_np[k], int(i_res[k]),
                                    int(j_res[k]))
                bo[k] = -1
                bc[k] = 0
                for q, (oc, cn) in enumerate(runs):
                    bo[k, q] = _OP_CHARS.index(oc)
                    bc[k, q] = cn
                bl[k] = len(runs)
        endpos[m] = maxloc[:B] - 1
        blk_ops[m] = bo
        blk_cnt[m] = bc
        blk_len[m] = bl
    return endpos, blk_ops, blk_cnt, blk_len


def _ops_to_runs(ops_row: np.ndarray, i_resid: int, j_resid: int):
    """RLE one backtrack row (walk order) + leftover border runs
    (smw.c:99-104).  Returns [(op_char, count), ...] in push order."""
    live = ops_row[ops_row != 3]
    runs = []
    if live.size:
        cut = np.flatnonzero(np.diff(live)) + 1
        starts = np.concatenate([[0], cut])
        ends = np.concatenate([cut, [live.size]])
        runs = [
            (_OP_CHARS[live[s]], int(e - s)) for s, e in zip(starts, ends)
        ]
    if i_resid:
        runs.append(("I", int(i_resid)))
    if j_resid:
        runs.append(("D", int(j_resid)))
    return runs


# --------------------------------------------------------------------------
# The executor
# --------------------------------------------------------------------------


_SEED_CACHE: dict = {}


def seed_depth(k: int, platform: str) -> int:
    """Seed-table depth for an index on ``platform``: the configured k,
    clamped to 6 on the CPU backend, where a 4^12-row build (~400 M
    rank gathers) costs more than the rounds it shortens."""
    return min(k, 6) if platform == "cpu" else k


def _platform_of(x: jax.Array) -> str:
    return next(iter(x.devices())).platform


def _seed_for(fmi: FMIndex, k: int):
    """Per-(index, k) seed-table cache.  Keyed by the buckets array's
    identity; the entry pins a strong reference to that array so its
    id cannot recycle while cached.  Bounded (tables reach ~400 MB at
    k=12): new indexes evict the cache wholesale."""
    from bwt_tpu.ops import search as search_ops

    key = (id(fmi.buckets), k)
    ent = _SEED_CACHE.get(key)
    if ent is not None and ent[0] is fmi.buckets:
        return ent[1]
    tab = search_ops.build_seed_table(fmi, k=k)
    if len(_SEED_CACHE) >= 4:
        _SEED_CACHE.clear()
    _SEED_CACHE[key] = (fmi.buckets, tab)
    return tab


class QueryService:
    """Reusable device-side state for executor runs: the FM-index, an
    optional genome codes array (required for nw/sw requests), and the
    per-run pattern bank."""

    def __init__(self, fmi: FMIndex, genome=None, config=None):
        from bwt_tpu.config import DEFAULT

        self.fmi = fmi
        self.config = config or DEFAULT
        self.scoring = self.config.dp_scoring
        if genome is None:
            self.genome_dev = None
        elif isinstance(genome, jax.Array) and genome.dtype == jnp.int32:
            self.genome_dev = genome  # pre-uploaded (amortized reuse)
        else:
            self.genome_dev = jax.jit(lambda g: g.astype(jnp.int32))(
                jnp.asarray(np.asarray(genome, np.uint8))
            )
        self._reads: list[np.ndarray] = []
        self._has_n = False
        self.bank = None
        self._seed = None

    @property
    def seed(self):
        """Lazy per-index seed table for the device automatons'
        mms/bsearch rounds (config.automaton_seed_k); ``None`` when
        disabled.  Cached per (index buckets, k) at module level — the
        table is index-derived state like the index itself (a k=12
        build runs ~400 M rank gathers), and drivers construct fresh
        QueryServices per batch/chunk."""
        if self._seed is None and self.config.automaton_seed_k:
            self._seed = _seed_for(self.fmi, seed_depth(
                self.config.automaton_seed_k, _platform_of(self.fmi.buckets)))
        return self._seed

    def add_read(self, codes) -> int:
        """Register a read's codes; returns its bank row handle."""
        arr = np.asarray(codes, np.uint8)
        self._reads.append(arr)
        if (arr == 5).any():
            self._has_n = True
        self.bank = None
        return len(self._reads) - 1

    def add_reads_batch(self, codes_list, *, with_revcomp: bool = False):
        """Vectorized bulk registration replacing per-read
        :meth:`add_read` calls (65 k Python calls + per-read N scans
        measured ~0.4 s per 32 k-read batch).  Appends every read —
        interleaved with its reverse complement when ``with_revcomp``
        (read k at rows base+2k / base+2k+1) — builds the device bank
        in one upload, and returns (first_row, lengths).  Uniform-length
        batches fill the matrix with strided assignments."""
        from bwt_tpu.codec import _COMPLEMENT

        base = len(self._reads)
        if base:
            # mixing with add_read would force a slow rebuild; the
            # drivers always bulk-load a fresh service
            raise ValueError("add_reads_batch requires an empty bank")
        n = len(codes_list)
        stride = 2 if with_revcomp else 1
        is_mat = isinstance(codes_list, np.ndarray) and codes_list.ndim == 2
        if is_mat:
            # uniform code-matrix fast path (align_reads' ndarray
            # input): no per-read length scan or row stack
            Lb = _pad16(max(codes_list.shape[1], 1))
            lens = np.full((n,), codes_list.shape[1], np.int32)
            uniform = n > 0
        else:
            Lb = _pad16(max((len(r) for r in codes_list), default=1))
            lens = np.fromiter((len(r) for r in codes_list), np.int32, n)
            uniform = n > 0 and (lens == lens[0]).all()
        R = _pow2(stride * n)
        mat = np.zeros((R, Lb), np.uint8)
        with _span("A.bank.pack"):
            if uniform:
                fwd = codes_list.astype(np.uint8, copy=False) if is_mat \
                    else np.stack(
                        [np.asarray(r, np.uint8) for r in codes_list])
                mat[0 : stride * n : stride, : lens[0]] = fwd
                if with_revcomp:
                    mat[1 : 2 * n : 2, : lens[0]] = _COMPLEMENT[fwd][:, ::-1]
            else:
                for k, r in enumerate(codes_list):
                    arr = np.asarray(r, np.uint8)
                    mat[stride * k, : len(r)] = arr
                    if with_revcomp:
                        mat[stride * k + 1, : len(r)] = _COMPLEMENT[arr][::-1]
        rows = mat[: stride * n]
        with _span("A.bank.views"):
            # per-read row views materialize lazily: 65 k view objects
            # cost ~35 ms per batch and only add_read mixing or an
            # _ensure_bank rebuild ever touches them
            self._reads = _LazyRowViews(rows, lens, stride)
            mx = int(rows.max(initial=0))
            self._has_n = mx == 5
        with _span("A.bank.upload"):
            # ship 2-bit (4-bit when any N) packed codes: 4x less
            # host->device traffic than raw uint8
            bits = 4 if mx > 3 else 2
            self.bank = _unpack_bank(
                jnp.asarray(_pack_bank_host(mat, bits)), Lb, bits)
        return base, lens

    def read_lengths(self) -> np.ndarray:
        """(n_reads,) int32 lengths of the registered reads — without
        materializing the lazy per-read row views (the aligner's
        phase-B pure-M check needs only the lengths)."""
        r = self._reads
        if isinstance(r, _LazyRowViews) and r._src is not None:
            return np.asarray(r._src[1], np.int32)
        return np.fromiter((len(x) for x in r), np.int32, len(r))

    def reset_reads(self) -> None:
        """Drop all registered reads (drivers call this at entry, so a
        reused service keeps only the genome upload and compiled
        programs — the bank does not grow across calls)."""
        self._reads = []
        self._has_n = False
        self.bank = None

    def _ensure_bank(self):
        if self.bank is None:
            Lb = _pad16(max((len(r) for r in self._reads), default=1))
            # rows pad to a power of two: the bank's row count is part
            # of every service/DP jit signature, so stable shapes stop
            # per-batch-size recompiles
            R = _pow2(len(self._reads))
            mat = np.zeros((R, Lb), np.uint8)
            for k, r in enumerate(self._reads):
                mat[k, : len(r)] = r
            self.bank = jax.jit(lambda b: b.astype(jnp.int32))(
                jnp.asarray(mat)
            )
        return self.bank


class BatchExecutor:
    """Runs a set of request-yielding generators to completion; each
    round of pending requests executes as one fused device dispatch
    (plus one flattened unc_sa_range call and per-shape DP calls when
    those ops are present)."""

    def __init__(self, fmi_or_service: FMIndex | QueryService, genome=None):
        if isinstance(fmi_or_service, QueryService):
            self.svc = fmi_or_service
        else:
            self.svc = QueryService(fmi_or_service, genome)
        self.fmi = self.svc.fmi
        self.stats = {
            "rounds": 0, "svc_calls": 0, "dp_calls": 0, "rng_calls": 0,
            "t_req": 0.0, "t_dev": 0.0, "t_reply": 0.0, "t_dp": 0.0,
            "t_gen": 0.0, "t_fetch": 0.0,
        }

    # -- round executors -------------------------------------------------

    def _start_service(self, items: list[tuple[int, tuple]]):
        """items: (gen_index, request) pairs for the fused opcodes.
        Dispatches the device call and returns a pending handle —
        materialization happens in :meth:`_finish_service`, so a
        round's service/range/DP dispatches overlap in flight."""
        import time as _time

        t0 = _time.perf_counter()
        bank = self.svc._ensure_bank()
        # pad lanes to the next power of two: the tail rounds (few live
        # generators) then run on small cheap programs; the persistent
        # compile cache makes each pow2 size a one-time cost
        B = _pow2(len(items))
        opc = np.zeros((B,), np.int32)
        row = np.zeros((B,), np.int32)
        off = np.zeros((B,), np.int32)
        ln = np.zeros((B,), np.int32)
        sp = np.zeros((B,), np.int32)
        ep = np.zeros((B,), np.int32)
        idx = np.zeros((B,), np.int32)
        ext = False
        for k, (_, r) in enumerate(items):
            op = r[0]
            opc[k] = _OPC[op]
            if op in ("mms", "bsearch"):
                row[k], off[k], ln[k] = r[1], r[2], r[3]
            elif op in ("mms_continue", "mms_continue_full", "mms_ext",
                        "bsearch_ext"):
                # mms_ext: sp=curpos, ep=curgap; bsearch_ext: sp=window
                # lo, ep=window width (see _service_step)
                row[k], off[k], ln[k], sp[k], ep[k] = r[1:6]
                ext = ext or op in ("mms_ext", "bsearch_ext")
            elif op == "unc_sa":
                idx[k] = r[1]
            else:  # crank: c rides in sp
                sp[k], idx[k] = r[1], r[2]
        t1 = _time.perf_counter()
        out_dev = _service_step(
            self.fmi, bank,
            jnp.asarray(opc), jnp.asarray(row), jnp.asarray(off),
            jnp.asarray(ln), jnp.asarray(sp), jnp.asarray(ep),
            jnp.asarray(idx), resolve=self.svc._has_n, ext=ext,
        )
        # fetch only the union of columns this round's opcodes consume
        needed = sorted({
            c for _, r in items for c in _OP_COLS[r[0]]
        })
        self.stats["svc_calls"] += 1
        self.stats["t_req"] += t1 - t0
        return out_dev, items, ln, t1, needed

    def _finish_service(self, pend, cols) -> dict[int, object]:
        """``cols``: {column id -> host (B,) array} for the round's
        needed columns (see _OP_COLS)."""
        import time as _time

        _out_dev, items, ln, t1, _needed = pend
        t2 = _time.perf_counter()
        self.stats["t_dev"] += t2 - t1
        replies: dict[int, object] = {}
        # one C-level conversion per fetched column (np-scalar int()
        # per field costs ~7 conversions per lane otherwise)
        n = len(items)
        cv = {c: a[:n].tolist() for c, a in cols.items()}
        for k, (i, r) in enumerate(items):
            op = r[0]
            if op == "mms":
                # 4th element: fused unc_sa(osp) — the position the
                # anchor path would ask for next
                replies[i] = (cv[_MMS_M][k], cv[_OSP][k], cv[_OEP][k],
                              cv[_POS][k])
            elif op == "mms_ext":
                # 4th element: the fused window scan's accepted genome
                # position (-1 = no interval entry in the window)
                replies[i] = (cv[_MMS_M][k], cv[_OSP][k], cv[_OEP][k],
                              cv[_WBEST][k])
            elif op == "mms_continue":
                replies[i] = (cv[_CONT_M][k], cv[_OSP][k], cv[_OEP][k])
            elif op == "mms_continue_full":
                # also exposes the FINAL (possibly emptied) interval —
                # rnaseqtest.c's top-of-loop break check means a search
                # emptied by its last character still reads
                # unc_sa(start) of that empty interval; ``pos`` is that
                # value, fused
                replies[i] = dict(
                    matched=cv[_CONT_M][k], sp=cv[_OSP][k],
                    ep=cv[_OEP][k], start=cv[_START][k],
                    end=cv[_END][k], nmatched=cv[_NM][k],
                    alive=bool(cv[_ALIVE][k]), pos=cv[_POS][k],
                )
            elif op in ("bsearch", "bsearch_ext"):
                ext = op == "bsearch_ext"
                replies[i] = dict(
                    start=cv[_START][k], end=cv[_END][k],
                    sp=cv[_OSP][k], ep=cv[_OEP][k],
                    nmatched=cv[_NM][k], alive=bool(cv[_ALIVE][k]),
                    skips=cv[_SKIPS][k], eff_len=int(ln[k]),
                    pos=cv[_POS][k],
                    wbest=cv[_WBEST][k] if ext else -1,
                    wrow=cv[_WROW][k] if ext else -1,
                )
            elif op == "unc_sa":
                replies[i] = cv[_POS][k]
            else:
                replies[i] = cv[_CRANK][k]
        self.stats["t_reply"] += _time.perf_counter() - t2
        return replies

    def _start_unc_sa_flat(self, idxs: list[int]):
        B = _pow2(len(idxs))
        arr = np.zeros((B,), np.int32)
        arr[: len(idxs)] = idxs
        return search.unc_sa(self.fmi, jnp.asarray(arr))

    def _start_isa(self, items: list[tuple[int, tuple]]):
        B = _pow2(len(items))
        plo = np.zeros((B,), np.int32)
        wid = np.zeros((B,), np.int32)
        for k, (_, r) in enumerate(items):
            plo[k] = r[1]
            wid[k] = r[2] - r[1]
        return (
            search.isa_window(self.fmi, jnp.asarray(plo), jnp.asarray(wid)),
            items,
        )

    def _finish_isa(self, pend, out) -> dict[int, object]:
        _out_dev, items = pend
        return {
            i: out[k, : max(int(r[2] - r[1]), 0)]
            for k, (i, r) in enumerate(items)
        }

    def _start_dp(self, items: list[tuple[int, tuple]]):
        """Group nw/sw requests by padded DP shape; one device call per
        shape bucket (device fill + device backtrack, host RLE)."""
        import time as _time

        t0 = _time.perf_counter()
        if self.svc.genome_dev is None:
            raise ValueError("nw/sw requests require a genome-backed QueryService")
        bank = self.svc._ensure_bank()
        buckets: dict[tuple[int, int], list[tuple[int, tuple]]] = {}
        for i, r in items:
            # coarse 32-wide shape buckets: fewer jit variants and
            # fewer, larger dispatches per round
            buckets.setdefault(dp_shape(r[3], r[6]), []).append((i, r))
        pend = []
        for (L1, L2), members in buckets.items():
            B = _pow2(len(members))
            f = np.zeros((8, B), np.int32)  # row roff rlen rrev gstart glen grev nw
            for k, (_, r) in enumerate(members):
                f[0, k], f[1, k], f[2, k], f[3, k] = r[1], r[2], r[3], r[4]
                f[4, k], f[5, k], f[6, k] = r[5], r[6], r[7]
                f[7, k] = 1 if r[0] == "nw" else 0
            out = _dp_step(
                bank, self.svc.genome_dev,
                *(jnp.asarray(f[j]) for j in range(8)), L1=L1, L2=L2,
                scoring=self.svc.scoring,
            )
            pend.append((out, members))
            self.stats["dp_calls"] += 1
        dt = _time.perf_counter() - t0
        self.stats["t_dp"] += dt
        self.stats["t_dp_start"] = self.stats.get("t_dp_start", 0.0) + dt
        return pend

    def _finish_dp(self, fetched) -> dict[int, object]:
        import time as _time

        t0 = _time.perf_counter()
        replies: dict[int, object] = {}
        for (maxloc, i_res, j_res, nrun, vals, counts), ops_dev, members \
                in fetched:
            n = len(members)
            # rare overflow (> _RLE_R runs in one lane): fetch that
            # bucket's raw ops once and decode those lanes host-side
            ops_np = (
                np.asarray(ops_dev) if int(np.max(nrun[:n], initial=0)) > _RLE_R
                else None
            )
            ml = maxloc.tolist()
            nr = nrun.tolist()
            vl = vals.tolist()
            cl = counts.tolist()
            ir = i_res.tolist()
            jr = j_res.tolist()
            for k, (i, r) in enumerate(members):
                if ops_np is not None and nr[k] > _RLE_R:
                    runs = _ops_to_runs(ops_np[k], ir[k], jr[k])
                else:
                    v, c = vl[k], cl[k]
                    runs = [
                        (_OP_CHARS[v[t]], c[t]) for t in range(nr[k])
                    ]
                    if ir[k]:
                        runs.append(("I", ir[k]))
                    if jr[k]:
                        runs.append(("D", jr[k]))
                if r[0] == "nw":
                    replies[i] = (ml[k] - 1, runs)
                else:
                    replies[i] = runs
        dt = _time.perf_counter() - t0
        self.stats["t_dp"] += dt
        self.stats["t_dp_finish"] = self.stats.get("t_dp_finish", 0.0) + dt
        return replies

    # -- scheduler -------------------------------------------------------

    def run(self, gens: list) -> list:
        """Drive all generators to completion; returns their values.

        Each round dispatches every live generator's request, collects
        the replies and steps the generators on the host."""
        n = len(gens)
        results = [None] * n
        live: dict[int, object] = {}
        pending: dict[int, tuple] = {}

        def step(i, send_value):
            try:
                pending[i] = gens[i].send(send_value)
                live[i] = gens[i]
            except StopIteration as e:
                results[i] = e.value
                live.pop(i, None)
                pending.pop(i, None)

        for i in range(n):
            step(i, None)

        import time as _time

        while live:
            self.stats["rounds"] += 1
            replies = self._collect_round(
                self._dispatch_round(list(live), pending))
            t0 = _time.perf_counter()
            for i, out in replies.items():
                step(i, out)
            self.stats["t_gen"] += _time.perf_counter() - t0
        return results

    def _dispatch_round(self, ids, pending):
        """Classify one round's pending requests, start every device
        call, and begin async device->host copies.  Returns a bundle
        for :meth:`_collect_round`."""
        import time as _time

        svc_items: list[tuple[int, tuple]] = []
        rng_items: list[tuple[int, tuple]] = []
        dp_items: list[tuple[int, tuple]] = []
        isa_items: list[tuple[int, tuple]] = []
        par_n: dict[int, int] = {}
        flat: list[tuple[object, tuple]] = []
        for i in ids:
            r = pending[i]
            if r[0] == "par":
                par_n[i] = len(r[1])
                flat.extend(((i, j), sub) for j, sub in enumerate(r[1]))
            else:
                flat.append((i, r))
        for key, r in flat:
            if r[0] in _OPC:
                svc_items.append((key, r))
            elif r[0] == "unc_sa_range":
                rng_items.append((key, r))
            elif r[0] == "isa_range":
                isa_items.append((key, r))
            elif r[0] in ("nw", "sw"):
                dp_items.append((key, r))
            else:  # pragma: no cover
                raise ValueError(f"unknown request op {r[0]!r}")
        import os

        log_t0 = None
        if os.environ.get("BWT_EXEC_LOG"):
            from collections import Counter

            ops_c = Counter(r[0] for _, r in flat)
            lns = [int(r[3]) for _, r in svc_items if len(r) > 3]
            dpsh = Counter(dp_shape(r[3], r[6]) for _, r in dp_items)
            log_t0 = _time.perf_counter()
            print(
                f"[exec] round {self.stats['rounds']}: gens={len(ids)} "
                f"lanes={len(svc_items)} maxln={max(lns, default=0)} "
                f"dp={len(dp_items)}{dict(dpsh) if dpsh else ''} "
                f"rng={len(rng_items)} ops={dict(ops_c)}",
                flush=True,
            )
        svc_pend = self._start_service(svc_items) if svc_items else None
        rng_pend = None
        spans = None
        if rng_items:
            t0 = _time.perf_counter()
            spans = [(int(r[1]), int(r[2])) for _, r in rng_items]
            flat_idx = [v for s, e in spans for v in range(s, e)]
            if flat_idx:
                rng_pend = (self._start_unc_sa_flat(flat_idx), len(flat_idx))
            self.stats["rng_calls"] += 1
            self.stats["t_dev"] += _time.perf_counter() - t0
        isa_pend = self._start_isa(isa_items) if isa_items else None
        dp_pend = self._start_dp(dp_items) if dp_items else None

        devs = []
        if svc_pend is not None:
            devs.extend(svc_pend[0][c] for c in svc_pend[4])
        if isa_pend is not None:
            devs.append(isa_pend[0])
        if rng_pend is not None:
            devs.append(rng_pend[0])
        if dp_pend is not None:
            for out, _members in dp_pend:
                devs.extend(out[:6])  # ops (out[6]) stays on device
        for d in devs:
            try:
                d.copy_to_host_async()
            except (AttributeError, NotImplementedError):  # pragma: no cover
                break  # backend without async copies; device_get still works
        return (devs, svc_pend, isa_pend, rng_pend, rng_items, spans, dp_pend,
                par_n, log_t0)

    def _collect_round(self, bundle) -> dict[int, object]:
        """Materialize one round's results with ONE
        jax.device_get (each separate np.asarray is its own blocking
        copy; a single device_get over the round's whole output list
        issues the copies concurrently) and unpack the replies."""
        import time as _time

        (devs, svc_pend, isa_pend, rng_pend, rng_items, spans, dp_pend,
         par_n, log_t0) = bundle
        t0 = _time.perf_counter()
        host = jax.device_get(devs)
        now = _time.perf_counter()
        self.stats["t_fetch"] += now - t0
        if log_t0 is not None:
            print(f"[exec]   collected: {now - log_t0:.3f}s "
                  f"(fetch {now - t0:.3f}s)", flush=True)
        hit = iter(host)
        replies: dict[int, object] = {}
        if svc_pend is not None:
            replies.update(self._finish_service(
                svc_pend, {c: next(hit) for c in svc_pend[4]}
            ))
        if isa_pend is not None:
            replies.update(self._finish_isa(isa_pend, next(hit)))
        if rng_items:
            t0 = _time.perf_counter()
            flat = (
                next(hit)[: rng_pend[1]]
                if rng_pend else np.zeros((0,), np.int32)
            )
            offp = 0
            for (i, _), (s, e) in zip(rng_items, spans):
                replies[i] = flat[offp : offp + (e - s)]
                offp += e - s
            self.stats["t_dev"] += _time.perf_counter() - t0
        if dp_pend is not None:
            replies.update(self._finish_dp(
                [(tuple(next(hit) for _ in range(6)), out[6], members)
                 for out, members in dp_pend]
            ))
        for i, n in par_n.items():
            replies[i] = [replies.pop((i, j)) for j in range(n)]
        return replies
