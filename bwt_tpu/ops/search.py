"""Batched FM-index search: lockstep backward search over read batches.

The reference walks one read at a time through ``reverse_search`` /
``mms`` / ``locate`` (seqindex.c:228-351), two rank() calls per
nucleotide.  Here thousands of reads advance in lockstep through a
``lax.fori_loop``: per step, a vectorized gather of Occ checkpoints +
packed BWT words and a popcount — the data-parallel shape of the same
O(m) algorithm.  Divergence (reads finishing at different steps)
becomes masking.

All quirks of the reference are preserved bit-exactly and noted inline:
  * ``reverse_search`` returns ``end - start + 1`` on completion
    (seqindex.c:241 — one more than the true match count) and 0 only
    if the interval emptied *before* the final character's update;
  * ``locate`` returns a position even when the final update emptied
    the interval (seqindex.c:258-277);
  * ``mms`` strips trailing N's, resolves in-pattern N's to the symbol
    with the most matches in the current interval (first-max ties,
    seqindex.c:330-340), and counts the initial character.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from bwt_tpu.index import FMIndex
from bwt_tpu.ops import rank as rank_ops


def _fetch_pair(fmi: FMIndex, start, end):
    """Bucket rows at (start, end): two independent gathers when the
    index is local (XLA fuses them; stacking them doubles the live
    buffer at multi-million-lane batches — the k=12 seed-table build
    OOMs compile-time HBM with the stacked form), ONE stacked fetch +
    single psum under tp (collective-count correctness,
    ops/rank.rows2)."""
    if fmi.tp_axis is None:
        ia = rank_ops._adjust(fmi.endloc, jnp.asarray(start))
        ib = rank_ops._adjust(fmi.endloc, jnp.asarray(end))
        return (rank_ops._rows(fmi.buckets, ia), ia & 63,
                rank_ops._rows(fmi.buckets, ib), ib & 63)
    return rank_ops.rows2(fmi.buckets, fmi.endloc, start, end,
                          fmi.tp_axis, fmi.bucket_rows)


def _interval_counts(fmi: FMIndex, start, end):
    """rank(d, end) - rank(d, start) for d in 0..3, shape (..., 4) —
    one row-gather per end."""
    rows_s, rs, rows_e, re_ = _fetch_pair(fmi, start, end)
    return rank_ops.row_ranks_all4(rows_e, re_) - \
        rank_ops.row_ranks_all4(rows_s, rs)


def take_c(C: jax.Array, c: jax.Array) -> jax.Array:
    """C[c] for c in 0..4 as a one-hot multiply (gather-free).  Result
    dtype == C's (pinned: x64 mode would widen the sum)."""
    oh = c[..., None] == jnp.arange(5, dtype=jnp.int32)
    return jnp.sum(C * oh, axis=-1, dtype=C.dtype)


def _step(fmi: FMIndex, c, start, end):
    rows_s, rs, rows_e, re_ = _fetch_pair(fmi, start, end)
    Cc = take_c(fmi.C, c)
    return (Cc + rank_ops._row_rank(rows_s, c, rs),
            Cc + rank_ops._row_rank(rows_e, c, re_))


def _resolve_step(fmi: FMIndex, c, start, end, lane_mask=None):
    """N-resolution (seqindex.c:330-340) + the LF interval step
    (seqindex.c:221) from ONE shared row fetch: the counts and the
    step both need the bucket rows at (start, end), so resolving N
    costs no extra gather or collective.  ``lane_mask`` restricts
    which lanes resolve (None = all); unresolved c==5 lanes step with
    the same deterministic rank(5) the unfused path computed.
    Returns (c', ns, ne)."""
    rows_s, rs, rows_e, re_ = _fetch_pair(fmi, start, end)
    counts = rank_ops.row_ranks_all4(rows_e, re_) - \
        rank_ops.row_ranks_all4(rows_s, rs)
    best = jnp.argmax(counts, axis=-1).astype(jnp.int32)
    sel = (c == 5) if lane_mask is None else (lane_mask & (c == 5))
    c = jnp.where(sel, best, c)
    Cc = take_c(fmi.C, c)
    return (c,
            Cc + rank_ops._row_rank(rows_s, c, rs),
            Cc + rank_ops._row_rank(rows_e, c, re_))


def trailing_n(patterns: jax.Array, lengths: jax.Array):
    """Count of trailing N's per read (mms's strip loop, seqindex.c:317-320).

    Gather-free: ``run[b, j]`` — the consecutive-N run length ending at
    ``j`` — is ``j - cummax(pos where non-N else -1)``, and the count
    of trailing N's of ``pattern[:len]`` is ``run[len-1]``, read with a
    one-hot multiply-reduce.  The previous form materialized a (B, L)
    ``take_along_axis`` (an elementwise-gather HLO, ~L gathered
    elements per lane); repeated-MMS drivers like ``anchor_scan`` call
    this once per trip, where that gather dominated the trip cost."""
    B, L = patterns.shape
    pos = jnp.arange(L, dtype=jnp.int32)[None, :]
    last_non_n = jax.lax.cummax(
        jnp.where(patterns != 5, pos, jnp.int32(-1)), axis=1
    )
    run = pos - last_non_n
    ci = jnp.clip(lengths - 1, 0, L - 1)[:, None]
    if L <= 128:
        out = jnp.sum(run * (pos == ci), axis=1)
    else:
        out = jnp.take_along_axis(run, ci, axis=1)[:, 0]
    return jnp.where(lengths > 0, out, 0).astype(jnp.int32)


@functools.partial(
    jax.jit, static_argnames=("resolve_n", "max_len", "dynamic")
)
def backward_search(
    fmi: FMIndex,
    patterns: jax.Array,  # (B, L) int32 codes, left-aligned
    lengths: jax.Array,  # (B,) int32
    *,
    resolve_n: bool = False,
    max_len: int | None = None,
    dynamic: bool = False,
):
    """Lockstep backward search of a read batch.

    Returns a dict of (B,)-arrays:
      start, end   — final SA interval I_{len-1} (frozen at first empty)
      sp, ep       — last nonempty interval (mms semantics)
      nmatched     — chars consumed while the interval stayed nonempty,
                     counting the initial character
      alive        — True iff the interval never emptied
    When ``resolve_n`` is set, trailing N's are stripped first and
    in-pattern N's resolved; nmatched then *excludes* the stripped
    trailing N's (callers add them back, seqindex.c:345-349).
    """
    B, L = patterns.shape
    steps = (max_len if max_len is not None else L)

    if resolve_n:
        skips = trailing_n(patterns, lengths)
        eff_len = lengths - skips
    else:
        skips = jnp.zeros_like(lengths)
        eff_len = lengths
    eff_len = jnp.maximum(eff_len, 1)

    # char processed at step t is pattern[b, eff_len-1-t]
    ci0 = jnp.clip(eff_len - 1, 0, L - 1)[:, None]
    if L <= 128:
        c0 = jnp.sum(
            patterns * (jnp.arange(L, dtype=jnp.int32) == ci0), axis=1
        )
    else:
        c0 = jnp.take_along_axis(patterns, ci0, axis=1)[:, 0]
    if resolve_n:
        # A fully-N read leaves c0 == 5; the reference would read
        # C[5]/C[6] out of bounds here (UB).  We clamp to 'A'.
        c0 = jnp.where(c0 == 5, 0, c0)
    start = take_c(fmi.C, c0)
    end = take_c(fmi.C, c0 + 1)
    alive = end > start
    nmatched = alive.astype(jnp.int32)
    state = (start, end, start, end, nmatched, alive)
    state = _run_loop(fmi, patterns, eff_len, state, 1, steps, resolve_n,
                      dynamic=dynamic)
    start, end, sp, ep, nmatched, alive = state
    return dict(
        start=start, end=end, sp=sp, ep=ep,
        nmatched=nmatched, alive=alive, skips=skips, eff_len=eff_len,
    )


def _run_loop(fmi, patterns, eff_len, state, t0, steps, resolve_n,
              dynamic=False):
    """The lockstep LF loop from step ``t0`` (char eff_len-1-t) on.

    ``dynamic=True`` swaps the static ``fori_loop`` for a
    ``while_loop`` that exits as soon as no lane is still active —
    bit-identical (the skipped iterations are all-lane no-ops), and
    the right form for repeated-MMS drivers like ``anchor_scan``
    whose late trips involve only short straggler prefixes: the trip
    then costs max-live-length steps, not the padded pattern width."""
    L = patterns.shape[1]

    def select_char(t):
        ci = jnp.clip(eff_len - 1 - t, 0, L - 1)
        if L <= 128:
            # one-hot multiply-reduce instead of a dynamic gather:
            # chosen for an earlier accelerator, unmeasured on the H100
            oh = jnp.arange(L, dtype=jnp.int32) == ci[:, None]
            return jnp.sum(patterns * oh, axis=1)
        return jnp.take_along_axis(patterns, ci[:, None], axis=1)[:, 0]

    def body(t, state):
        start, end, sp, ep, nmatched, alive = state
        active = alive & (t <= eff_len - 1)
        c = select_char(t)
        if resolve_n:
            c, ns, ne = _resolve_step(fmi, c, start, end)
        else:
            ns, ne = _step(fmi, c, start, end)
        ok = ne > ns
        start = jnp.where(active, ns, start)
        end = jnp.where(active, ne, end)
        upd = active & ok
        sp = jnp.where(upd, ns, sp)
        ep = jnp.where(upd, ne, ep)
        nmatched = nmatched + upd.astype(jnp.int32)
        alive = alive & (~active | ok)
        return start, end, sp, ep, nmatched, alive

    if not dynamic:
        return jax.lax.fori_loop(t0, steps, body, state)

    def wcond(carry):
        t, (start, end, sp, ep, nmatched, alive) = carry
        return (t < steps) & jnp.any(alive & (t <= eff_len - 1))

    def wbody(carry):
        t, st = carry
        return t + 1, body(t, st)

    return jax.lax.while_loop(wcond, wbody, (jnp.int32(t0), state))[1]


# --------------------------------------------------------------------------
# k-mer seed table: skip the first k steps of every search
# --------------------------------------------------------------------------


@functools.partial(
    jax.tree_util.register_dataclass, data_fields=["rows"], meta_fields=["k"]
)
@dataclasses.dataclass(frozen=True)
class SeedTable:
    """Precomputed backward-search state for every k-mer suffix.

    ``rows[key]`` = (start, end, sp, ep, nmatched, alive) after the
    first k steps of :func:`backward_search` on the k-mer encoded by
    ``key`` (char processed at step t in bits 2t..2t+1).  Built by
    literally running ``backward_search`` over all 4^k patterns, so
    seeded continuation is bit-exact by construction.  256 KiB + a
    single row-gather per read at k=8 — replacing k steps x 2
    rank-gathers each.  Valid only for reads of length >= k with no N
    (code 5) among their last k characters.
    """

    rows: jax.Array  # (4^k, 6) int32
    k: int


@functools.partial(jax.jit, static_argnames=("k",))
def _seed_rows(fmi: FMIndex, k: int) -> jax.Array:
    """backward_search state after k steps for every key, computed
    straight from the key bits (char at step t = bits 2t..2t+1) so no
    (4^k, k) pattern matrix is materialized — k=12 (16.7M keys) runs
    in a few hundred MB."""
    n = 4 ** k
    keys = jnp.arange(n, dtype=jnp.int32)
    c0 = keys & 3
    start = take_c(fmi.C, c0)
    end = take_c(fmi.C, c0 + 1)
    alive = end > start
    nmatched = alive.astype(jnp.int32)
    sp, ep = start, end

    def body(t, state):
        start, end, sp, ep, nmatched, alive = state
        c = (keys >> (2 * t)) & 3
        ns, ne = _step(fmi, c, start, end)
        ok = ne > ns
        start = jnp.where(alive, ns, start)
        end = jnp.where(alive, ne, end)
        upd = alive & ok
        sp = jnp.where(upd, ns, sp)
        ep = jnp.where(upd, ne, ep)
        nmatched = nmatched + upd.astype(jnp.int32)
        alive = alive & ok
        return start, end, sp, ep, nmatched, alive

    start, end, sp, ep, nmatched, alive = jax.lax.fori_loop(
        1, k, body, (start, end, sp, ep, nmatched, alive)
    )
    return jnp.stack(
        [start, end, sp, ep, nmatched, alive.astype(jnp.int32)], axis=1
    )


def build_seed_table(fmi: FMIndex, k: int = 8) -> SeedTable:
    return SeedTable(rows=_seed_rows(fmi, k), k=k)


def _seed_key(patterns, lengths, k):
    """key = sum_t pattern[len-1-t] << 2t, gather-free: char j carries
    weight 4^(len-1-j) when it is one of the last k characters."""
    L = patterns.shape[1]
    j = jnp.arange(L, dtype=jnp.int32)[None, :]
    t = lengths[:, None] - 1 - j  # processing step of char j
    in_window = (t >= 0) & (t < k)
    w = jnp.where(in_window, jnp.int32(1) << (2 * jnp.clip(t, 0, 15)), 0)
    return jnp.sum(patterns * w, axis=1)


@functools.partial(jax.jit, static_argnames=("max_len",))
def backward_search_seeded(
    fmi: FMIndex,
    table: SeedTable,
    patterns: jax.Array,
    lengths: jax.Array,
    *,
    max_len: int | None = None,
):
    """backward_search with the first k steps answered by the seed
    table (one row-gather).  Caller contract: every length >= k and no
    N codes among the last k characters of any read."""
    B, L = patterns.shape
    steps = max_len if max_len is not None else L
    rows = jnp.take(table.rows, _seed_key(patterns, lengths, table.k), axis=0)
    state = (
        rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3],
        rows[:, 4], rows[:, 5] > 0,
    )
    start, end, sp, ep, nmatched, alive = _run_loop(
        fmi, patterns, lengths, state, table.k, steps, False
    )
    return dict(
        start=start, end=end, sp=sp, ep=ep, nmatched=nmatched, alive=alive,
        skips=jnp.zeros_like(lengths), eff_len=lengths,
    )


def _search(fmi, patterns, lengths, seed_table):
    if seed_table is not None:
        return backward_search_seeded(fmi, seed_table, patterns, lengths)
    return backward_search(fmi, patterns, lengths)


@jax.jit
def reverse_search(fmi: FMIndex, patterns, lengths, seed_table=None):
    """Match-count per read, preserving the reference's +1 quirk
    (seqindex.c:228-242): returns ``end - start + 1`` when the loop
    completes, 0 if the interval emptied before the final update."""
    r = _search(fmi, patterns, lengths, seed_table)
    emptied_early = (~r["alive"]) & (r["nmatched"] <= lengths - 2)
    return jnp.where(emptied_early, 0, r["end"] - r["start"] + 1)


@jax.jit
def count_matches(fmi: FMIndex, patterns, lengths, seed_table=None):
    """True number of matches (no reference quirk)."""
    r = _search(fmi, patterns, lengths, seed_table)
    return jnp.where(r["alive"], r["end"] - r["start"], 0)


@functools.partial(jax.jit, static_argnames=("max_steps", "ladder"))
def unc_sa(fmi: FMIndex, idx: jax.Array, max_steps: int | None = None,
           *, ladder: bool = True):
    """Batched SA[idx] via LF walks to the nearest sampled entry
    (seqindex.c:244-255).  ``idx`` (B,) in the index dtype (int32;
    int64 for wide indexes).

    The walk stops when the ROW index hits a multiple of the sample
    rate (the reference's ``while (idx % 32)``, seqindex.c:247-251) —
    a ~Geometric(1/rate) step count per lane, so the LOCKSTEP maximum
    over a B-lane batch is ~``rate * ln(B)`` (≈440 at rate 32 / 1 M
    lanes), not ``rate - 1``: a naive full-width loop pays ~rate*ln(B)
    * B row-gathers where the useful work is only ~rate * B.  Wide
    batches therefore run a COMPACTION LADDER: ``rate`` steps at full
    width (survivor fraction (1-1/rate)^rate ≈ 0.36), then argsort
    -pack the live lanes into a quarter..1/64-width buffer for each
    further band, scattering finished walks back.  A final unbounded
    full-width loop guarantees exactness — if the ladder finished
    everything (the overwhelming case) its condition is a single
    cheap reduction; any lane a capacity bound left unfinished (the
    fractions carry >= 1.9x margin at these widths) completes there
    bit-exactly.  Per-lane step sequences are unchanged, so results
    are identical to the plain loop (pinned by test_search's staged
    -vs-plain equality)."""
    idx = jnp.asarray(idx, fmi.sa_samples.dtype)
    mask = fmi.sa_rate - 1
    shift = fmi.sa_rate.bit_length() - 1
    B = int(idx.shape[0])

    def walk(i0, steps0, cap_t):
        """The reference walk, early-exiting, optionally t-capped."""
        def cond(state):
            i, steps, t = state
            more = jnp.any((i & mask) != 0)
            if cap_t is not None:
                more = more & (t < cap_t)
            return more

        def body(state):
            i, steps, t = state
            live = (i & mask) != 0
            nxt = rank_ops.lf(fmi.buckets, fmi.C, fmi.endloc, i,
                              tp_axis=fmi.tp_axis, nrows=fmi.bucket_rows)
            i = jnp.where(live, nxt, i)
            steps = steps + live.astype(i.dtype)
            return i, steps, t + 1

        i, steps, _ = jax.lax.while_loop(
            cond, body, (i0, steps0, jnp.int32(0)))
        return i, steps

    i, steps = idx, jnp.zeros_like(idx)
    if ladder and max_steps is None and fmi.tp_axis is None and B >= 4096:
        # ladder bands: fraction of B each packed stage runs at.  The
        # expected survivor fraction entering band s is
        # (1-1/rate)^(s*rate) ≈ e^-s: .37 .14 .05 .018 .0067 .0025 —
        # a band's capacity overflow self-heals (missed lanes stay
        # live and later bands re-collect them); only the LAST band's
        # leak reaches the full-width safety loop, so the last band
        # runs UNCAPPED at 1/256 width (its stragglers would
        # otherwise drag the safety loop through ~rate*ln(B) more
        # full-width steps — measured ~2 s of the 3.3 s rate-32 walk
        # at 2M lanes).  Compaction is flatnonzero (a cumsum), not an
        # argsort — ~5x cheaper per band at these widths.  A dead
        # -lane fill (index 0) walks as a no-op and duplicate
        # scatter writes carry identical values.
        rate = int(fmi.sa_rate)
        i, steps = walk(i, steps, rate)
        for frac, cap_t in ((2, rate), (4, rate), (8, rate), (32, rate),
                            (64, rate), (256, None)):
            cap = B // frac
            live = (i & mask) != 0
            perm = jnp.flatnonzero(live, size=cap, fill_value=0)
            si, ss = walk(jnp.take(i, perm), jnp.take(steps, perm),
                          cap_t)
            i = i.at[perm].set(si)
            steps = steps.at[perm].set(ss)
    # exact completion (and the small-batch / tp / capped path)
    i, steps = walk(i, steps, max_steps)
    x = rank_ops.take_sharded(fmi.sa_samples, i >> shift, fmi.tp_axis,
                              fmi.sample_rows) + steps
    return jnp.where(x > fmi.length, x - (fmi.length + 1), x)


@jax.jit
def locate(fmi: FMIndex, patterns, lengths, seed_table=None):
    """First-match position per read (seqindex.c:258-277); -1 when the
    interval emptied before the final character (quirk preserved: an
    empty *final* interval still locates ``start``)."""
    r = _search(fmi, patterns, lengths, seed_table)
    emptied_early = (~r["alive"]) & (r["nmatched"] <= lengths - 2)
    pos = unc_sa(fmi, r["start"])
    return jnp.where(emptied_early, -1, pos)


@functools.partial(jax.jit, static_argnames=("W",))
def isa_window(fmi: FMIndex, plo: jax.Array, width: jax.Array, *, W: int = 32):
    """Batched positional range query: ``rows[b, j] = SA^-1[plo[b]+j]``
    for ``j < width[b]`` (and ``0 <= plo+j <= length``), else -1.

    The reference answers "is any SA row of this interval located near
    position X?" by walking unc_sa over EVERY interval entry
    (single_align.c:218-223, rnaseqtest.c:110-121) — O(interval width),
    which grows linearly with genome size.  The inverse query is O(W):
    anchor at the ISA sample just above the window's top and LF-chain
    downward (``ISA[p-1] = lf(ISA[p])``), collecting one row per step.
    Requires ``fmi.isa_samples`` (built by :func:`bwt_tpu.build_index`;
    absent on reference-format file loads).

    Contract: ``width <= W``; lanes with ``width <= 0`` return all -1.
    """
    if fmi.isa_samples is None:
        raise ValueError("isa_window requires an index with isa_samples")
    plo = jnp.asarray(plo, jnp.int32)
    width = jnp.asarray(width, jnp.int32)
    n = fmi.length
    r = fmi.sa_rate
    shift = r.bit_length() - 1
    B = plo.shape[0]

    p_hi = jnp.minimum(plo + width - 1, n)
    anchor = jnp.minimum((p_hi + r - 1) >> shift << shift, n)
    anchor = jnp.maximum(anchor, 0)
    if fmi.tp_axis is None:
        samp = jnp.take(fmi.isa_samples, anchor >> shift, mode="clip")
    else:
        # anchor <= n keeps anchor>>shift inside the real rows, so the
        # tp-local fetch needs no clip beyond take_sharded's own
        samp = rank_ops.take_sharded(
            fmi.isa_samples, anchor >> shift, fmi.tp_axis,
            fmi.sample_rows,
        )
    if n % r:
        # ISA[length] == 0 (the sentinel suffix is SA row 0) anchors
        # the tail window when length is not a multiple of the rate
        row = jnp.where(anchor == n, 0, samp)
    else:
        row = samp

    out = jnp.full((B, W), -1, jnp.int32)
    jidx = jnp.arange(W, dtype=jnp.int32)[None, :]
    floor = jnp.maximum(plo, 0)
    # adaptive trip count: lane b contributes rows only while
    # pcur = anchor - t >= floor, so the loop can stop at the WIDEST
    # lane's span instead of the static worst case (sa_rate-1) + W —
    # bit-exact (later steps are fully-masked no-ops) and typically
    # ~2.5x fewer LF fetches (anchor overshoot 0..rate-1 plus the
    # actual window width, vs rate-1 + W)
    tmax = jnp.max(jnp.where(width > 0, anchor - floor + 1, 0))
    tmax = jnp.minimum(tmax, (r - 1) + W)

    def cond(state):
        t, _, _ = state
        return t < tmax

    def body(state):
        t, row, out = state
        pcur = anchor - t
        ok = (pcur >= floor) & (pcur <= p_hi) & (width > 0)
        sel = (jidx == (pcur - plo)[:, None]) & ok[:, None]
        out = jnp.where(sel, row[:, None], out)
        live = pcur > floor
        nxt = rank_ops.lf(fmi.buckets, fmi.C, fmi.endloc, row,
                          tp_axis=fmi.tp_axis, nrows=fmi.bucket_rows)
        row = jnp.where(live, nxt, row)
        return t + 1, row, out

    _, _, out = jax.lax.while_loop(cond, body, (jnp.int32(0), row, out))
    return out


def walk_and_window_tp(fmi: FMIndex, walk0, wlo, wwid, *, W: int = 32):
    """:func:`unc_sa` + :func:`isa_window` fused into ONE sequential
    loop with a single (tuple) psum per iteration — the tp-sharded
    form of the service epilogue.

    Why it exists: as separate programs the unc_sa while-loop and the
    isa_window scan are data-independent, and XLA:CPU's thunk executor
    runs independent thunks concurrently per device.  Every shard_map
    collective shares ``channel_id=1``, so two concurrently-executing
    collectives on the same 'tp' group collide in the in-process
    rendezvous and abort (repro: tools/repro_xla_cpu_rendezvous.py;
    ``lax.optimization_barrier`` cannot fix it — the CPU pipeline
    erases barriers before thunk emission).  Fusing the two walks into
    one loop makes every collective part of one sequential chain — and
    costs fewer loop trips than running them back to back (max instead
    of sum).

    Returns ``(pos, rows)`` bit-identical to
    ``(unc_sa(fmi, walk0), isa_window(fmi, wlo, wwid, W=W))``.
    Requires ``fmi.tp_axis`` and ``fmi.isa_samples``."""
    ax = fmi.tp_axis
    n = fmi.length
    r = fmi.sa_rate
    mask = r - 1
    shift = r.bit_length() - 1
    B = walk0.shape[0]
    isa_T = (r - 1) + W

    wlo = jnp.asarray(wlo, jnp.int32)
    wwid = jnp.asarray(wwid, jnp.int32)
    p_hi = jnp.minimum(wlo + wwid - 1, n)
    anchor = jnp.minimum((p_hi + r - 1) >> shift << shift, n)
    anchor = jnp.maximum(anchor, 0)
    floor = jnp.maximum(wlo, 0)
    jidx = jnp.arange(W, dtype=jnp.int32)[None, :]
    # adaptive scan bound, exactly as isa_window's (replicated within
    # the tp group, so the loop stays collectively consistent)
    isa_T = jnp.minimum(
        jnp.max(jnp.where(wwid > 0, anchor - floor + 1, 0)),
        jnp.int32(isa_T),
    )

    per = fmi.buckets.shape[0]
    pers = fmi.isa_samples.shape[0]
    my = jax.lax.axis_index(ax)

    def fetch(i_unc, row):
        """Bucket rows for both walks + the ISA anchor sample through
        ONE variadic all-reduce."""
        ia = rank_ops._adjust(fmi.endloc, i_unc)
        ib = rank_ops._adjust(fmi.endloc, row)
        i2 = jnp.stack([ia, ib])
        # out-of-contract indices must reproduce the replicated path's
        # jnp.take semantics (negative wrap, then dtype-min fill) —
        # see ops/rank._rows
        bi = (i2 >> 6).astype(jnp.int32)
        bi = jnp.where(bi < 0, bi + fmi.bucket_rows, bi)
        b_oob = (bi < 0) | (bi >= fmi.bucket_rows)
        loc = bi - my * per
        rows = jnp.take(fmi.buckets, jnp.clip(loc, 0, per - 1), axis=0)
        rows = jnp.where(((loc >= 0) & (loc < per))[..., None], rows, 0)
        si = anchor >> shift
        si = jnp.where(si < 0, si + fmi.sample_rows, si)
        s_oob = (si < 0) | (si >= fmi.sample_rows)
        sl = si - my.astype(jnp.int32) * pers
        samp = jnp.take(fmi.isa_samples, jnp.clip(sl, 0, pers - 1))
        samp = jnp.where((sl >= 0) & (sl < pers), samp, 0)
        rows, samp = jax.lax.psum((rows, samp), ax)
        rows = jnp.where(b_oob[..., None],
                         jnp.iinfo(fmi.buckets.dtype).min, rows)
        samp = jnp.where(s_oob, jnp.iinfo(fmi.isa_samples.dtype).min,
                         samp)
        return rows[0], ia & 63, rows[1], ib & 63, samp

    if n % r:
        # ISA[length] == 0 anchors the tail window (isa_window)
        def init_row(samp):
            return jnp.where(anchor == n, 0, samp)
    else:
        def init_row(samp):
            return samp

    def cond(s):
        t, i, steps, row, out = s
        return jnp.any((i & mask) != 0) | (t < isa_T)

    def body(s):
        t, i, steps, row, out = s
        rows_u, ru, rows_i, ri, samp = fetch(i, row)
        # unc_sa step (search.unc_sa body, verbatim semantics)
        live_u = (i & mask) != 0
        nxt_u = rank_ops.row_lf(rows_u, fmi.C, fmi.endloc, i, ru)
        i = jnp.where(live_u, nxt_u, i)
        steps = steps + live_u.astype(jnp.int32)
        # isa_window: iteration t advances the row for scan step t-1,
        # then records scan step t (isa_window's body does record-then
        # -advance; splitting across iterations keeps one fetch/trip)
        nxt_r = rank_ops.row_lf(rows_i, fmi.C, fmi.endloc, row, ri)
        live_r = (anchor - (t - 1)) > floor
        row = jnp.where(t == 0, init_row(samp),
                        jnp.where(live_r, nxt_r, row))
        pcur = anchor - t
        ok = (pcur >= floor) & (pcur <= p_hi) & (wwid > 0) & (t < isa_T)
        sel = (jidx == (pcur - wlo)[:, None]) & ok[:, None]
        out = jnp.where(sel, row[:, None], out)
        return t + 1, i, steps, row, out

    _, i, steps, _, out = jax.lax.while_loop(
        cond, body,
        (jnp.int32(0), jnp.asarray(walk0, jnp.int32),
         jnp.zeros((B,), jnp.int32), jnp.zeros((B,), jnp.int32),
         jnp.full((B, W), -1, jnp.int32)),
    )
    x = rank_ops.take_sharded(fmi.sa_samples, i >> shift, ax,
                              fmi.sample_rows) + steps
    pos = jnp.where(x > n, x - (n + 1), x)
    return pos, out


# locate_fast (seed-and-verify locate) lived here through round 3 and
# was REMOVED in round 4: its own bench rows showed it losing in both
# regimes (rate-4: 1.55 M/s vs plain locate's 3.39; rate-32: 0.19 vs
# 0.73 — BENCH_r03).  The loss is structural: verification requires
# candidate POSITIONS, so each of the <=4 interval candidates pays an
# unc_sa LF walk — 4B lanes x ~(rate/2) steps of row-gathers vs plain
# locate's B x (L-k) search steps + one walk; fetch cost is linear in
# lanes x steps, so the candidate walks always swamp the saved search
# steps.  Plain locate (+ the k-seed table and a rate-4 index) is the
# fast path (searchtest.c:77-94's workload: bench extras locate16/
# locate30_r4).


@jax.jit
def loc_search(fmi: FMIndex, patterns, lengths, seed_table=None):
    """Final SA interval (start, end) per read — seed-search entry
    point (seqindex.c:280-309).  Frozen at the first empty interval,
    exactly like the reference's early break."""
    r = _search(fmi, patterns, lengths, seed_table)
    return r["start"], r["end"]


@jax.jit
def mms(fmi: FMIndex, patterns, lengths):
    """Batched maximum mappable suffix (seqindex.c:314-351).

    Returns (matched, sp, ep): matched includes stripped trailing N's;
    (sp, ep) is the last nonempty interval (or the initial interval if
    it was already empty)."""
    r = backward_search(fmi, patterns, lengths, resolve_n=True)
    matched = r["nmatched"] + r["skips"]
    return matched, r["sp"], r["ep"]


@functools.partial(jax.jit, static_argnames=())
def mms_continue(
    fmi: FMIndex,
    patterns: jax.Array,  # (B, L) codes
    lengths: jax.Array,  # (B,) number of chars to process (suffix pattern[:len])
    sp: jax.Array,
    ep: jax.Array,
):
    """Batched continuation of an MMS search (single_align.c:26-46).

    Processes pattern[len-1] .. pattern[0] starting from interval
    (sp, ep).  Returns (matched, sp', ep'): matched is -1 - adjusted
    exactly like the reference (an empty incoming interval yields -1;
    a first-step failure yields 0)."""
    B, L = patterns.shape
    start, end = sp, ep
    alive = end > start
    incoming_empty = ~alive
    nmatched = jnp.zeros_like(lengths)
    osp, oep = sp, ep

    def body(t, state):
        start, end, osp, oep, nmatched, alive = state
        active = alive & (t <= lengths - 1)
        ci = jnp.clip(lengths - 1 - t, 0, L - 1)
        c = jnp.take_along_axis(patterns, ci[:, None], axis=1)[:, 0]
        c, ns, ne = _resolve_step(fmi, c, start, end)
        ok = ne > ns
        start = jnp.where(active, ns, start)
        end = jnp.where(active, ne, end)
        upd = active & ok
        osp = jnp.where(upd, ns, osp)
        oep = jnp.where(upd, ne, oep)
        nmatched = nmatched + upd.astype(jnp.int32)
        alive = alive & (~active | ok)
        return start, end, osp, oep, nmatched, alive

    start, end, osp, oep, nmatched, alive = jax.lax.fori_loop(
        0, L, body, (start, end, osp, oep, nmatched, alive)
    )
    matched = nmatched - incoming_empty.astype(jnp.int32)
    return matched, osp, oep
