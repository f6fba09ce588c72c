"""Spliced / RNA-seq alignment prototype — the rnaseqtest.c model family.

Re-implements the reference's maximum-mappable-suffix splice chaining
(``mms_search`` rnaseqtest.c:43-68, position-aware ``mms_continue``
:75-127, ``mms_gap`` :131-160, ``rna_seq`` driver :172-243) as host
generators over batched device backward-search, preserving the
reference's return-value quirks:

  * break-path positions are ``unc_sa(start_of_empty_interval) + 1``
    while full-match positions are ``unc_sa(start)`` with no +1
    (rnaseqtest.c:55 vs :67);
  * ``*len_p`` on the break path is ``len - i + 1`` with ``i`` one
    below the failing character (= chars_matched + 3);
  * the driver's reported position is the *first* anchor's — later
    continuations never update it (``genpos = mmspos`` only,
    rnaseqtest.c:189-241).

The reference's debug prints (rnaseqtest.c:113, :117) are not
reproduced.

**Documented divergence (reference UB):** rnaseqtest.c's own search
loops index ``fmi->C[pattern[i]]`` / ``rank(fmi, pattern[i], ...)``
with the raw character (e.g. :49-50, :60-61), so an N (code 5) read
reads ``C[5]``/``C[6]`` out of bounds — measured: a trailing N
SIGSEGVs the binary, a mid-read N returns a stable-but-arbitrary
position.  Ours is defined on N reads (the search sees the
deterministic rank(5) the fused service computes; device == host
engines, pinned by tests) but does NOT match the C's garbage values —
the same class of divergence as search_reads' ASCII bug
(models/exact.py).  Parity suites drive this family with ACGT reads,
like the reference's self-benchmark (rnaseqtest.c:313-327).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from bwt_tpu import codec
from bwt_tpu.index import FMIndex
from bwt_tpu.models.batch_exec import (
    _ALIVE, _END, _NM, _POS, _START, _WROW, OP_BEXT, OP_BSEARCH, OP_CONT,
    OP_NONE, BatchExecutor, _service_core,
)


def _eval_mms_search(r: dict, length: int, cutoff: int):
    """Pure post-processing of one mms_search bsearch reply
    (rnaseqtest.c:43-68); shared by the sequential generator and the
    speculative retry chain in :func:`rna_seq_gen`."""
    if r["alive"] or r["nmatched"] >= length - 1:
        return r["pos"], length
    len_p = r["nmatched"] + 3
    if r["nmatched"] + 2 > cutoff:
        return r["pos"] + 1, len_p
    return -1, len_p


def _eval_mms_gap(r: dict, length: int):
    """Pure post-processing of one mms_gap bsearch reply
    (rnaseqtest.c:131-160)."""
    if r["alive"] or r["nmatched"] >= length - 1:
        return r["pos"], length
    return -1, r["nmatched"] + 3


def mms_search_gen(row: int, length: int, cutoff: int):
    """Returns (pos, len_p) per rnaseqtest.c:43-68.  ``row`` is the
    read's bank handle; the search covers its length-prefix.

    The reference checks emptiness at the TOP of its loop
    (rnaseqtest.c:51), so an interval emptied by the final character
    exits the loop normally and takes the full-match path — returning
    ``unc_sa(start)`` of the empty interval.  ``nmatched >= length-1``
    captures exactly that case.  Both paths read the service's fused
    ``pos`` (= unc_sa of the final interval start) — one round, not
    two."""
    r = yield ("bsearch", row, 0, length)
    return _eval_mms_search(r, length, cutoff)


def mms_gap_gen(row: int, length: int, cutoff: int, lastpos: int):
    """Returns (pos, len_p) per rnaseqtest.c:131-160.  Note the
    reference's break-path candidate scan (rnaseqtest.c:146-151)
    iterates ``for (j = start; j < end; ...)`` over the *empty*
    interval that triggered the break — it never executes, so any
    break returns -1; only a full match yields a position.  As in
    :func:`mms_search_gen`, emptied-by-the-final-character counts as a
    full match (top-of-loop check, rnaseqtest.c:144)."""
    r = yield ("bsearch", row, 0, length)
    return _eval_mms_gap(r, length)


def mms_continue_gen(row: int, length: int, cutoff: int, lastpos: int,
                     use_isa: bool = False):
    """Position-aware continuation (rnaseqtest.c:75-127): at the loop
    iteration where ``len - i == cutoff`` (i.e. after cutoff-1 matched
    characters), scan the current interval for a match within 6 nt
    upstream of ``lastpos`` and, if found, narrow the interval to it
    before continuing.  ``use_isa`` answers the scan with one
    inverse-SA window query (identical narrowing; see
    ops.search.isa_window)."""
    if length < cutoff:
        # the checkpoint is unreachable; behavior collapses to mms_gap
        return (yield from mms_gap_gen(row, length, cutoff, lastpos))
    # Phase 1: the cutoff-1 characters before the checkpoint
    # (the slice pattern[length-cutoff+1 : length] of the prefix).
    # With isa_samples the checkpoint scan is answered IN the same
    # dispatch (fused inverse-SA window, batch_exec OP_BEXT): the
    # minimal in-interval row among positions
    # [lastpos - cutoff - 6, lastpos) == the first entry the
    # reference's SA-row scan accepts (rnaseqtest.c:110-121).
    fuse = use_isa and cutoff + 6 <= 32
    if fuse:
        r = yield ("bsearch_ext", row, length - cutoff + 1, cutoff - 1,
                   lastpos - cutoff - 6, cutoff + 6)
    else:
        r = yield ("bsearch", row, length - cutoff + 1, cutoff - 1)
    if not r["alive"]:
        # Emptied before the checkpoint: len - i <= cutoff at the
        # break, so the acceptance test (rnaseqtest.c:86) always fails.
        return -1, r["nmatched"] + 3
    # Checkpoint (len - i == cutoff): scan current matches.  Without
    # the fused window, fetch the candidate walk lazily in
    # geometrically growing chunks — the scan almost always narrows
    # within the first few entries while the interval width grows
    # linearly with genome size; chunking preserves the exact scan
    # order.
    start, end = r["start"], r["end"]
    if fuse:
        if r["wrow"] >= 0:
            start, end = r["wrow"], r["wrow"] + 1
    else:
        base, w = start, 32
        narrowed = False
        while base < end and not narrowed:
            hi = min(end, base + w)
            poss = yield ("unc_sa_range", base, hi)
            for k, p in enumerate(np.asarray(poss)):
                pos = int(p)
                if pos < lastpos and lastpos - (pos + cutoff) <= 6:
                    start, end = base + k, base + k + 1
                    narrowed = True
                    break
            base, w = hi, w * 4
    # Phase 2: the remaining prefix pattern[:length-cutoff+1].  The
    # full-match path triggers whenever every top-of-loop emptiness
    # check passed — including an interval emptied by the very last
    # character (rnaseqtest.c:84-103), which reads unc_sa() of the
    # EMPTY final interval.
    l2 = length - cutoff + 1
    r = yield ("mms_continue_full", row, 0, l2, start, end)
    if r["alive"] or r["nmatched"] >= l2 - 1:
        return r["pos"], length
    # Break: the candidate scan is over the empty interval (see
    # mms_gap_gen) — always -1.  len - i + 1 == (cutoff-1) + m + 3.
    return -1, cutoff + r["matched"] + 2


def rna_seq_gen(row: int, length: int, anchor_cutoff: int = 14,
                cont_cutoff: int = 10, use_isa: bool = False,
                spec: int = 1):
    """The rna_seq driver (rnaseqtest.c:172-243).  Returns the first
    anchor's genome position (the value the reference printf's).
    Cutoffs default to the reference's hardcoded 14 / 10
    (rnaseqtest.c:197, :219).

    ``spec``: speculative depth for the two length-decrement retry
    loops (rnaseqtest.c:198-201 anchor hunt, :227-236 gap re-anchor).
    Each retry's request is ``bsearch`` of a deterministically shorter
    prefix, so up to ``spec`` of them issue as one batch_exec "par"
    round; replies are consumed in sequential order and the unused
    tail discarded — outputs identical at any depth."""
    i = length
    mmspos, mmslen = yield from mms_search_gen(row, i, anchor_cutoff)
    while mmspos == -1 and i > anchor_cutoff:
        lens = []
        j = i
        while j > anchor_cutoff and len(lens) < spec:
            j -= 1
            lens.append(j)
        if len(lens) == 1:
            replies = [(yield ("bsearch", row, 0, lens[0]))]
        else:
            replies = yield ("par", [("bsearch", row, 0, l) for l in lens])
        for l, r in zip(lens, replies):
            i = l
            mmspos, mmslen = _eval_mms_search(r, l, anchor_cutoff)
            if mmspos != -1:
                break
    i -= mmslen
    while i > 18:
        genpos = mmspos
        i -= 3
        nextpos, mmslen = yield from mms_continue_gen(
            row, i, cont_cutoff, genpos, use_isa
        )
        if nextpos != -1:
            i -= mmslen
        else:
            while i > anchor_cutoff:
                lens = []
                j = i
                while j > anchor_cutoff and len(lens) < spec:
                    j -= 1
                    lens.append(j)
                if len(lens) == 1:
                    replies = [(yield ("bsearch", row, 0, lens[0]))]
                else:
                    replies = yield (
                        "par", [("bsearch", row, 0, l) for l in lens]
                    )
                done = False
                for l, r in zip(lens, replies):
                    i = l
                    nextpos, mmslen = _eval_mms_gap(r, l)
                    if nextpos != -1:
                        i -= mmslen
                        done = True
                        break
                if done:
                    break
    return mmspos


# --------------------------------------------------------------------------
# Device-resident automaton: the whole rna_seq driver as ONE dispatch
# --------------------------------------------------------------------------

# per-lane phases of the driver state machine (rnaseqtest.c:172-243)
_P_DONE, _P_ANCHOR, _P_CONT1, _P_CONTC, _P_CONT2, _P_GAP = range(6)
# lane count at which the automaton switches to two-stage live-lane
# compaction (tests lower it to force the path on small batches)
_COMPACT_AT = 4096


# test hook: a nonzero value overrides the automaton's iteration cap
# (static jit arg) — used to force the capped->fallback escape
_TEST_CAP = 0


def _ladder(n: int) -> tuple[int, ...]:
    """Geometric compaction thresholds (see
    models/aligner._compact_ladder); reads this module's _COMPACT_AT
    at call time so tests can force the staged path on small
    batches."""
    if n < _COMPACT_AT:
        return ()
    floor = max(_COMPACT_AT // 16, 4)
    out = []
    t = n // 4
    while t >= floor and len(out) < 4:
        out.append(t)
        t //= 4
    return tuple(out)


@functools.partial(
    jax.jit, static_argnames=("ac", "cc", "resolve", "compact",
                              "cap_steps", "seed_k")
)
def _rna_seq_automaton(
    fmi: FMIndex,
    bank: jax.Array,   # (R, Lb) int32 pattern bank, one row per lane
    lens: jax.Array,   # (R,) int32 read lengths (0 on pad lanes)
    live0: jax.Array,  # (R,) bool — False on pad lanes
    seed_rows=None,    # (4^seed_k, 6) SeedTable rows or None
    *,
    ac: int,           # anchor cutoff (rnaseqtest.c:197's 14)
    cc: int,           # continuation cutoff (rnaseqtest.c:219's 10)
    resolve: bool,
    compact: int = 0,
    cap_steps: int = 0,
    seed_k: int = 0,
):
    """The full rna_seq driver (rnaseqtest.c:172-243) as one jitted
    ``lax.while_loop``: every iteration issues one fused service op per
    live lane (the op the host generator would yield) and advances a
    vectorized phase machine.  Per-lane op sequences — and therefore
    outputs — are identical to :func:`rna_seq_gen` on the inverse-SA
    path; the host's only involvement is one dispatch and one (R,)
    fetch, vs one round trip per scheduler round for the generator
    executor (the round-trip + host-generator-stepping cost).

    Phases issue: ANCHOR/GAP/CONTC -> bsearch(0, i); CONT1 ->
    bsearch_ext (phase 1 of mms_continue, fused inverse-SA window);
    CONT2 -> mms_continue_full.  Requires ``fmi.isa_samples`` and
    ``cc + 6 <= 32`` (the generator's fuse condition).

    ``compact`` (int or decreasing tuple of thresholds) enables the
    staged straggler run (same scheme as the aligner automaton,
    models/aligner._align_automaton): lane finish rounds skew heavily
    — typical reads anchor in a handful of iterations while
    hunt-exhausting reads walk ~3 rounds per remaining character — so
    once <= threshold lanes are live, an argsort+gather packs them
    (and their bank rows) into a narrower loop; results scatter back
    through the stage chain.  Device-side only, bit-exact for any
    value."""
    R, Lb = bank.shape
    # every <=3-iteration chain (CONT1 -> CONT2 -> gap-entry) lowers i
    # by >= 1 or terminates, so 3*Lb + slack bounds the trip count;
    # the cap is a safety net, never the exit in practice — and a lane
    # still live at the cap is returned with ``capped`` set so the
    # driver re-runs it on the host generator instead of reporting its
    # mid-flight result
    cap = jnp.int32(cap_steps if cap_steps else 4 * Lb + 64)

    def outer(x):
        """The driver's while (i > 18) re-check plus the ``i -= 3``
        continuation entry (rnaseqtest.c:209-219); 18 is the
        reference's hardcoded give-up bound."""
        y = x - 3
        ph_c = jnp.where(y < cc, _P_CONTC, _P_CONT1)
        return (
            jnp.where(x > 18, ph_c, _P_DONE).astype(jnp.int32),
            jnp.where(x > 18, y, x),
        )

    def to_gap(x):
        """Gap-hunt entry/continue: while (i > ac) { --i; mms_gap }
        (rnaseqtest.c:227-236); exhaustion falls through to outer()."""
        ph_o, i_o = outer(x)
        again = x > ac
        return (
            jnp.where(again, _P_GAP, ph_o).astype(jnp.int32),
            jnp.where(again, x - 1, i_o),
        )

    def cond(s):
        return (s[0] < cap) & jnp.any(s[1] != _P_DONE)

    def body(s, bank, rows, zeros):
        it, ph, i, res, cs, ce = s
        is_bs = (ph == _P_ANCHOR) | (ph == _P_GAP) | (ph == _P_CONTC)
        opc = jnp.where(
            ph == _P_DONE, OP_NONE,
            jnp.where(is_bs, OP_BSEARCH,
                      jnp.where(ph == _P_CONT1, OP_BEXT, OP_CONT)),
        ).astype(jnp.int32)
        off = jnp.where(ph == _P_CONT1, i - cc + 1, 0)
        ln = jnp.where(
            ph == _P_CONT1, cc - 1,
            jnp.where(ph == _P_CONT2, i - cc + 1,
                      jnp.where(ph == _P_DONE, 0, i)),
        )
        sp = jnp.where(ph == _P_CONT1, res - cc - 6,
                       jnp.where(ph == _P_CONT2, cs, 0))
        ep = jnp.where(ph == _P_CONT1, cc + 6,
                       jnp.where(ph == _P_CONT2, ce, 0))
        out = _service_core(
            fmi, bank, opc, rows, off, ln, sp, ep, zeros,
            resolve=resolve, ext=True, with_crank=False,
            seed_rows=seed_rows, seed_k=seed_k,
        )
        st, en = out[_START], out[_END]
        nm, alive = out[_NM], out[_ALIVE] > 0
        pos, wrow = out[_POS], out[_WROW]

        # success exit shared by GAP / CONTC / CONT2: mmslen == i, so
        # i -= mmslen lands on 0 and outer(0) is DONE
        ph_s, i_s = jnp.int32(_P_DONE), jnp.int32(0)
        ph_f, i_f = to_gap(i)

        # ANCHOR: _eval_mms_search + the hunt loop (rnaseqtest.c:197-201)
        full = alive | (nm >= i - 1)
        mmspos = jnp.where(full, pos, jnp.where(nm + 2 > ac, pos + 1, -1))
        mmslen = jnp.where(full, i, nm + 3)
        hunt = (mmspos == -1) & (i > ac)
        ph_acc, i_acc = outer(i - mmslen)
        a_ph = jnp.where(hunt, _P_ANCHOR, ph_acc)
        a_i = jnp.where(hunt, i - 1, i_acc)
        a_res = jnp.where(hunt, res, mmspos)

        # GAP / CONTC: _eval_mms_gap (rnaseqtest.c:131-160; mms_continue
        # with length < cutoff collapses to mms_gap)
        gsucc = jnp.where(alive | (nm >= i - 1), pos, -1) != -1
        g_ph = jnp.where(gsucc, ph_s, ph_f)
        g_i = jnp.where(gsucc, i_s, i_f)

        # CONT1: mms_continue phase 1 — dead interval fails straight to
        # the gap hunt; else narrow to the window's accepted row (wrow)
        # when one exists (rnaseqtest.c:84-121)
        ncs = jnp.where(wrow >= 0, wrow, st)
        nce = jnp.where(wrow >= 0, wrow + 1, en)
        c1_ph = jnp.where(alive, _P_CONT2, ph_f)
        c1_i = jnp.where(alive, i, i_f)

        # CONT2: mms_continue phase 2 over pattern[:i-cc+1]
        l2 = i - cc + 1
        c2succ = jnp.where(alive | (nm >= l2 - 1), pos, -1) != -1
        c2_ph = jnp.where(c2succ, ph_s, ph_f)
        c2_i = jnp.where(c2succ, i_s, i_f)

        gap_like = (ph == _P_GAP) | (ph == _P_CONTC)
        ph2 = jnp.where(
            ph == _P_ANCHOR, a_ph,
            jnp.where(gap_like, g_ph,
                      jnp.where(ph == _P_CONT1, c1_ph,
                                jnp.where(ph == _P_CONT2, c2_ph, ph))),
        )
        i2 = jnp.where(
            ph == _P_ANCHOR, a_i,
            jnp.where(gap_like, g_i,
                      jnp.where(ph == _P_CONT1, c1_i,
                                jnp.where(ph == _P_CONT2, c2_i, i))),
        )
        res2 = jnp.where(ph == _P_ANCHOR, a_res, res)
        cs2 = jnp.where(ph == _P_CONT1, ncs, cs)
        ce2 = jnp.where(ph == _P_CONT1, nce, ce)
        return it + 1, ph2, i2, res2, cs2, ce2

    def stage(bank):
        n = bank.shape[0]
        rows = jnp.arange(n, dtype=jnp.int32)
        zeros = jnp.zeros((n,), jnp.int32)
        return lambda s: body(s, bank, rows, zeros)

    zeros = jnp.zeros((R,), jnp.int32)
    ph0 = jnp.where(live0, _P_ANCHOR, _P_DONE).astype(jnp.int32)
    state = (jnp.int32(0), ph0, lens, jnp.full((R,), -1, jnp.int32),
             zeros, zeros)
    thresholds = (compact,) if isinstance(compact, int) else tuple(compact)
    thresholds = tuple(t for t in thresholds if t)
    cur_state, cur_bank = state, bank
    trail = []  # (pre-compaction state, live-lane perm) per stage
    for th in thresholds:
        s1 = jax.lax.while_loop(
            lambda s, _th=th: cond(s) & (
                jnp.sum((s[1] != _P_DONE).astype(jnp.int32)) > _th
            ),
            stage(cur_bank), cur_state,
        )
        perm = jnp.argsort((s1[1] == _P_DONE).astype(jnp.int32))[:th]
        trail.append((s1, perm))
        cur_state = (s1[0],) + tuple(x[perm] for x in s1[1:])
        cur_bank = cur_bank[perm]
    final = jax.lax.while_loop(cond, stage(cur_bank), cur_state)
    for s1, perm in reversed(trail):
        final = (final[0],) + tuple(
            f.at[perm].set(c) for f, c in zip(s1[1:], final[1:]))
    return final[3], final[1] != _P_DONE


def _rna_seq_automaton_mesh(mesh, fmi, bank, lens, live0, seed=None, *,
                            ac, cc, resolve, compact=0, cap_steps=0):
    """Data-parallel automaton: lanes shard over the mesh's 'dp' axis;
    with a replicated index each shard runs its while_loop locally
    with zero collectives, with a tp view (``fmi.tp_axis`` set) the
    same program's gathers go local-block + psum over 'tp' (lanes
    replicate within a tp group, keeping the loop collectively
    consistent).  Each dp shard exits as soon as its own lanes finish.
    Bit-identical to the single-device automaton (lanes are
    independent)."""
    import functools

    from jax.sharding import NamedSharding, PartitionSpec as P

    from bwt_tpu.parallel.mesh import _shard_map, fmi_spec_tree

    inner = functools.partial(
        _rna_seq_automaton, ac=ac, cc=cc, resolve=resolve,
        compact=compact, cap_steps=cap_steps,
        seed_k=0 if seed is None else seed.k)
    if seed is None:
        f = _shard_map(
            lambda fmi_, b, l, v: inner(fmi_, b, l, v),
            mesh,
            in_specs=(fmi_spec_tree(fmi), P("dp", None), P("dp"),
                      P("dp")),
            out_specs=P("dp"),
            check=False,
        )
        extra = ()
    else:
        f = _shard_map(
            lambda fmi_, b, l, v, sr: inner(fmi_, b, l, v, sr),
            mesh,
            in_specs=(fmi_spec_tree(fmi), P("dp", None), P("dp"),
                      P("dp"), P()),  # seed rows replicate
            out_specs=P("dp"),
            check=False,
        )
        extra = (seed.rows,)
    dp = NamedSharding(mesh, P("dp"))
    return jax.jit(f)(
        fmi,
        jax.device_put(bank, NamedSharding(mesh, P("dp", None))),
        jax.device_put(lens, dp),
        jax.device_put(live0, dp),
        *extra,
    )


def rna_seq_device(fmi: FMIndex, reads, *, config=None, service=None,
                   mesh=None):
    """Device-resident :func:`rna_seq`: the whole driver runs as one
    jitted while_loop (see :func:`_rna_seq_automaton`).  Same outputs
    as the generator path; requires ``fmi.isa_samples`` and
    ``cont_cutoff + 6 <= 32``.

    The cyclic GC is paused for the duration (restored on exit) — see
    models/aligner._align_reads_device for the measurement; the result
    assembly allocates cycle-free containers only."""
    import gc

    was_enabled = gc.isenabled()
    gc.disable()
    try:
        return _rna_seq_device_inner(fmi, reads, config=config,
                                     service=service, mesh=mesh)
    finally:
        if was_enabled:
            gc.enable()


def _rna_seq_device_inner(fmi, reads, *, config=None, service=None,
                          mesh=None):
    from bwt_tpu.config import DEFAULT
    from bwt_tpu.models.batch_exec import QueryService

    cfg = config or (service.config if service is not None else DEFAULT)
    if fmi.isa_samples is None:
        raise ValueError("rna_seq_device requires an index with isa_samples")
    if cfg.rnaseq_cont_cutoff + 6 > 32:
        raise ValueError("rna_seq_device requires cont_cutoff + 6 <= 32")
    svc = service if service is not None else QueryService(fmi)
    if isinstance(reads, np.ndarray) and reads.ndim == 2:
        # uniform code-matrix fast path (the aligner's, models/aligner
        # .align_reads): skips ~10 us/read of per-read Python prep
        codes_list = np.ascontiguousarray(reads).astype(
            np.uint8, copy=False)
    else:
        codes_list = [
            codec.encode_read(r)
            if isinstance(r, (str, bytes))
            else np.asarray(r, np.uint8)
            for r in reads
        ]
    n = len(codes_list)

    fmi_r = fmi
    if mesh is not None:
        from bwt_tpu.parallel.mesh import (
            replicate_index, shard_index, tp_view,
        )

        if mesh.shape.get("tp", 1) > 1:
            fmi_r = tp_view(shard_index(fmi, mesh))
        else:
            fmi_r = replicate_index(fmi, mesh)

    seed = svc.seed  # built once on the master service

    def dispatch(svc_i, sub, resolve):
        svc_i.reset_reads()
        m = len(sub)
        _base, rl = svc_i.add_reads_batch(sub)
        bank = svc_i.bank
        R = bank.shape[0]
        if mesh is not None and R % mesh.shape["dp"]:
            bank = jnp.concatenate(
                [bank, jnp.zeros((mesh.shape["dp"] - R, bank.shape[1]),
                                 bank.dtype)]
            )
            R = bank.shape[0]
        lens = np.zeros(R, np.int32)
        lens[:m] = rl
        live0 = np.zeros(R, bool)
        live0[:m] = True
        if resolve is None:
            resolve = svc_i._has_n
        if mesh is not None:
            local = R // mesh.shape["dp"]
            return _rna_seq_automaton_mesh(
                mesh, fmi_r, bank, jnp.asarray(lens), jnp.asarray(live0),
                seed,
                ac=cfg.rnaseq_anchor_cutoff, cc=cfg.rnaseq_cont_cutoff,
                resolve=resolve,
                compact=_ladder(local),
                cap_steps=_TEST_CAP,
            )
        return _rna_seq_automaton(
            fmi, bank, jnp.asarray(lens), jnp.asarray(live0),
            None if seed is None else seed.rows,
            ac=cfg.rnaseq_anchor_cutoff, cc=cfg.rnaseq_cont_cutoff,
            resolve=resolve,
            compact=_ladder(R),
            cap_steps=_TEST_CAP,
            seed_k=0 if seed is None else seed.k,
        )

    def fetch(out_pair, sub):
        """Materialize one chunk's results; lanes still live at the
        automaton's iteration cap re-run on the host generator (their
        device state is mid-flight garbage) — bit-exact by
        construction, like the aligner's escapes."""
        from bwt_tpu.parallel.mesh import host_fetch

        res, capped = host_fetch(out_pair)
        m = len(sub)
        res = np.asarray(res)[:m].astype(np.int32)
        bad = np.nonzero(np.asarray(capped)[:m])[0]
        if bad.size:
            svc_f = QueryService(fmi, config=cfg)
            gens = []
            for k in bad:
                row = svc_f.add_read(sub[k])
                gens.append(rna_seq_gen(
                    row, len(sub[k]), cfg.rnaseq_anchor_cutoff,
                    cfg.rnaseq_cont_cutoff, True,
                    cfg.rnaseq_spec_depth,
                ))
            vals = BatchExecutor(svc_f).run(gens)
            res[bad] = np.asarray(vals, np.int32)
        return res

    chunk = cfg.search_batch
    if n <= chunk:
        out_pair = dispatch(svc, codes_list, None)
        return fetch(out_pair, codes_list)
    # software pipeline over chunks: chunk i's bank build / dispatch
    # overlaps chunk i-1's device execution (the fetch happens after
    # the next dispatch is queued).  One compiled signature across
    # chunks: resolve decided globally, per-chunk services keep each
    # bank alive until its fetch.
    resolve = any((np.asarray(r) == 5).any() for r in codes_list)
    out = np.empty(n, np.int32)
    prev = None
    for lo in range(0, n, chunk):
        sub = codes_list[lo : lo + chunk]
        res = dispatch(QueryService(fmi, config=cfg), sub, resolve)
        if prev is not None:
            plo, psub, pres = prev
            out[plo : plo + len(psub)] = fetch(pres, psub)
        prev = (lo, sub, res)
    plo, psub, pres = prev
    out[plo : plo + len(psub)] = fetch(pres, psub)
    return out


def rna_seq(fmi: FMIndex, reads, *, config=None, service=None,
            engine: str = "auto", mesh=None):
    """Batched spliced-alignment driver: returns the anchor position
    per read (np.int32 array).  Pass a reusable
    :class:`~bwt_tpu.models.batch_exec.QueryService` to amortize
    device state across calls.

    ``engine``: "device" runs the whole driver as one jitted
    while_loop (:func:`rna_seq_device`); "host" runs the generator
    executor; "auto" (default) picks the device automaton whenever its
    requirements hold (isa_samples present, fusible cutoffs) — outputs
    are identical either way (test_models.py pins both to the C
    harness)."""
    from bwt_tpu.config import DEFAULT
    from bwt_tpu.models.batch_exec import QueryService

    cfg = config or (service.config if service is not None else DEFAULT)
    if engine not in ("auto", "device", "host"):
        raise ValueError(f"unknown engine {engine!r}")
    use_dev = engine == "device" or (
        engine == "auto"
        and fmi.isa_samples is not None
        and cfg.rnaseq_cont_cutoff + 6 <= 32
    )
    if mesh is not None and not use_dev:
        raise ValueError("mesh= requires the device engine "
                         "(an index with isa_samples)")

    if use_dev:
        return rna_seq_device(fmi, reads, config=cfg,
                              service=service, mesh=mesh)
    svc = service if service is not None else QueryService(fmi)
    svc.reset_reads()
    gens = []
    for r in reads:
        p = (
            codec.encode_read(r)
            if isinstance(r, (str, bytes))
            else np.asarray(r, np.uint8)
        )
        row = svc.add_read(p)
        gens.append(
            rna_seq_gen(
                row, len(p), cfg.rnaseq_anchor_cutoff,
                cfg.rnaseq_cont_cutoff,
                fmi.isa_samples is not None,
                cfg.rnaseq_spec_depth,
            )
        )
    return np.asarray(BatchExecutor(svc).run(gens), np.int32)
