"""Anchored seed-and-extend alignment — the single_align.c model family.

Per-read semantics are bit-exact with the reference drivers
(``align_read_anchored`` single_align.c:163-298, ``mms_mismatch``
:50-160, ``align_read`` :300-358), including their retry budgets,
proximity tolerances, stack resets, and the head-alignment return-value
quirk (the final head block returns ``curpos - len`` while the in-loop
one returns ``curpos - x``, single_align.c:271 vs :297).  Each read's
control flow runs as a host generator; FM-index queries execute as one
fused batched device dispatch per round via
:class:`~bwt_tpu.models.batch_exec.BatchExecutor` (see that module for
the accelerator design rationale), and DP stitches (tail/head NW, gap
SW) run as batched device wavefront fills with device backtrack.

Deviations from the reference, all in C-undefined territory:
  * ``nmisses`` reads-before-write (single_align.c:166 declares it
    uninitialized; reachable when the initial read length <= anchor
    length): we define it as 0 — return value 0 either way.
  * ``mms_continue`` on a pattern containing N (code 5) indexes
    ``C[5]`` out of bounds in C; ours resolves N like ``mms`` does.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from bwt_tpu import codec
from bwt_tpu.index import FMIndex
from bwt_tpu.models.batch_exec import (
    _MMS_M, _OEP, _OSP, _POS, _WBEST, OP_MEXT, OP_MMS, OP_NONE,
    _OP_CHARS, BatchExecutor, QueryService, _service_core,
)
from bwt_tpu.utils.cigar import Cigar

DEFAULT_ANCHOR_LEN = 12  # single_align.c:483

_OPC_ARR = np.array(_OP_CHARS)  # int op code -> CIGAR char
_OPC_BYTES = np.frombuffer("".join(_OP_CHARS).encode(), np.uint8)

# optional wall-clock span profiling for the device-engine host path
# (tools/profile_phases.py assigns utils.profiling.ACTIVE; no-op
# otherwise)
from bwt_tpu.utils import profiling as _profiling  # noqa: E402
from bwt_tpu.utils.profiling import span as _span  # noqa: E402

_RUNS_RE = None  # compiled lazily (re import off the hot path)


class _RenderedCigar(Cigar):
    """A Cigar whose render string was precomputed VECTORIZED (numpy
    string ops over the fused compose's (chars, counts) matrix) — the
    per-read Python ops-list build measured ~8 us/read at 32 k lanes,
    the largest residual phase-B host cost.  ``ops`` materializes
    lazily by parsing the render string on first access (only tests,
    SAM soft-clip math, and callers that mutate results touch it);
    after any materialization the instance behaves exactly like a
    plain Cigar (render recomputes from ops, so mutation stays
    coherent)."""

    __slots__ = ("_render",)

    def __getattr__(self, name):  # only fires while the ops slot is unset
        if name == "ops":
            global _RUNS_RE
            if _RUNS_RE is None:
                import re

                _RUNS_RE = re.compile(r"(\d+)(\D)")
            # render order is top-first == reversed(ops)
            ops = [[op, int(cnt)]
                   for cnt, op in _RUNS_RE.findall(self._render)][::-1]
            self.ops = ops
            return ops
        raise AttributeError(name)

    def render(self) -> str:
        try:
            object.__getattribute__(self, "ops")
        except AttributeError:
            return self._render
        return super().render()

    def __bool__(self) -> bool:
        try:
            object.__getattribute__(self, "ops")
        except AttributeError:
            return bool(self._render)
        return super().__bool__()


def _yield_nw(row, roff, rlen, rrev, gstart, glen, grev, s: Cigar):
    """nw_fast via the batched DP service (smw.c:26-111): zero-length
    reads short-circuit (smw.c:28-30); runs flip onto ``s``."""
    if rlen == 0:
        return 0
    endpos, runs = yield ("nw", row, roff, rlen, rrev, gstart, max(glen, 0), grev)
    tmp = Cigar()
    for op, count in runs:
        tmp.push(op, count)
    tmp.flip_onto(s)
    return endpos


def _yield_sw(row, roff, rlen, rrev, gstart, glen, grev, s: Cigar):
    """sw_fast via the batched DP service (smw.c:117-200): both ends
    pinned, runs push directly (no flip)."""
    runs = yield ("sw", row, roff, rlen, rrev, gstart, max(glen, 0), grev)
    for op, count in runs:
        s.push(op, count)


# Candidate-interval scans fetch unc_sa_range lazily in geometrically
# growing chunks: the reference scans sequentially and almost always
# breaks within the first few entries (single_align.c:218-223,
# rnaseqtest.c:110-121), while interval width grows linearly with
# genome size — materializing whole intervals made big-genome runs
# locate-bound.  Chunking preserves the exact scan order/break point.
CAND_CHUNK = 32


# --------------------------------------------------------------------------
# mms_mismatch (single_align.c:50-160)
# --------------------------------------------------------------------------


def mms_mismatch_gen(genome: np.ndarray, row: int, length: int, sp: int, ep: int):
    """Hypothesis search at an MMS break: substitution / 1-3 nt genome
    insertion / 1-3 nt genome deletion, each validated by re-running
    mms_continue.  ``row`` is the read's bank handle.  Returns
    (best_align, sp', ep', genomeskips) where genomeskips is None when
    the reference would leave its out-param untouched (loop exhausted
    without an accepted hypothesis)."""
    if length < 2:  # single_align.c:54-61
        loc = yield ("unc_sa", sp)
        sub_c = int(genome[max(loc - 1, 0)])
        nsp = yield ("crank", sub_c, sp)
        return 1, nsp, nsp + 1, 0

    best_align = 0
    best_pos = -1
    genomeskips = None
    for i in range(sp, ep):
        # 1) substitution: LF-step the genome char before this match
        loc = yield ("unc_sa", i)
        sub_c = int(genome[max(loc - 1, 0)])
        sub_idx = yield ("crank", sub_c, i)
        ins_idx = sub_idx
        sub_align, sub_idx, sub_end = yield (
            "mms_continue", row, 0, length - 1, sub_idx, sub_idx + 1,
        )
        sub_align += 1
        best_align = sub_align
        best_pos = sub_idx
        if sub_align > 6 or sub_align == length:
            genomeskips = 0
            break

        # 1.5) genome insertion of 1..3 nt: LF-step without consuming
        # pattern.  NOTE the reference reuses ins_end across the three
        # attempts without resetting it (single_align.c:89-119); the
        # stale interval end is preserved here for parity.
        bleh = ins_idx
        ins_end = ins_idx + 1
        ins_align, ins_idx, ins_end = yield (
            "mms_continue", row, 0, length, ins_idx, ins_end,
        )
        if ins_align > 5 or ins_align == length:
            best_align = sub_align
            best_pos = sub_idx
            genomeskips = 1
            break

        sub_c = int(genome[max(loc - 2, 0)])
        ins_idx = yield ("crank", sub_c, bleh)
        blah = ins_idx
        ins_align, ins_idx, ins_end = yield (
            "mms_continue", row, 0, length, ins_idx, ins_end,
        )
        if ins_align > 5 or ins_align == length:
            best_align = sub_align
            best_pos = sub_idx
            genomeskips = 2
            break

        sub_c = int(genome[max(loc - 3, 0)])
        ins_idx = yield ("crank", sub_c, blah)
        ins_align, ins_idx, ins_end = yield (
            "mms_continue", row, 0, length, ins_idx, ins_end,
        )
        if ins_align > 5 or ins_align == length:
            best_align = sub_align
            best_pos = sub_idx
            genomeskips = 3
            break

        # 2) genome deletion of 1..3 nt: drop pattern chars, same spot
        for skip, thresh in ((1, 6), (2, 7), (3, 8)):
            del_align, del_idx, _ = yield (
                "mms_continue", row, 0, length - skip, i, i + 1,
            )
            del_align += skip
            if del_align > thresh or del_align == length:
                best_align = del_align
                best_pos = del_idx
                genomeskips = -skip
                break
        else:
            continue
        break

    return best_align, best_pos, best_pos + 1, genomeskips


# --------------------------------------------------------------------------
# align_read_anchored (single_align.c:163-298)
# --------------------------------------------------------------------------


def align_read_anchored_gen(
    genome: np.ndarray,
    glen: int,
    row: int,
    length: int,
    anchor_len: int,
    s: Cigar,
    use_isa: bool = False,
    spec: int = 1,
    isa_spec: int = 9,
):
    """Anchor in the read tail, NW-stitch the tail, chain backward via
    proximity-checked MMS segments with SW gap fills, NW-align the
    head.  ``row`` is the read's bank handle.  Returns the (0-based)
    genome position of the read start, or 0 for unaligned.

    ``use_isa``: answer the backward-extension proximity scan with one
    inverse-SA window query instead of walking unc_sa over the whole
    interval — identical result (the first interval entry the
    reference's scan would accept IS the minimal in-interval row among
    the window's positions), O(window) instead of O(interval).

    ``spec``: speculative depth for the anchor-hunt retry chain.  A
    miss deterministically retries at ln-3 (single_align.c:176-181),
    so up to ``spec`` retries issue as ONE round (batch_exec "par");
    replies are consumed exactly in the order the sequential loop
    would have issued them, so outputs are identical at any depth.
    With ``use_isa`` the backward-extension curgap loop (up to 9
    sequential rounds, single_align.c:224-247) also batches
    speculatively — its 9 requests depend only on (ln, curpos) at loop
    entry, so they issue in "par" chunks of ``isa_spec`` (each
    speculative lane costs a near-full-length LF loop on device;
    curgap=1 is accepted almost always on substitution-dominated
    reads, so small chunks waste fewer lanes — see
    config.isa_spec_depth)."""
    olen = length
    anchmisses = length // 10
    nmisses = 0  # C: uninitialized (see module docstring)
    curpos = -1
    anchlen = 0
    ln = length

    while ln > anchor_len and anchmisses > 0:
        nmisses = 0
        while ln > anchor_len and anchmisses > 0:
            # pos rides along with every mms (fused unc_sa(sp)) — the
            # accept path below needs it, and the kernel's LF-walk unit
            # runs for every lane regardless.  The retry chain (ln,
            # ln-3, ...) is issued speculatively, bounded by the loop's
            # own conditions.
            lns, l, a = [], ln, anchmisses
            while l > anchor_len and a > 0 and len(lns) < spec:
                lns.append(l)
                l -= 3
                a -= 1
            if len(lns) == 1:
                replies = [(yield ("mms", row, 0, ln))]
            else:
                replies = yield ("par", [("mms", row, 0, x) for x in lns])
            hit = None
            for rep in replies:
                seglen, sp, ep, pos = rep
                if seglen < anchor_len or ep - sp > 1:
                    anchmisses -= 1
                    ln -= 3
                    continue
                hit = rep
                break
            if hit is None:
                continue
            seglen, sp, ep, pos = hit
            ln -= seglen
            anchlen = seglen
            nmisses = olen // 5
            curpos = pos
            # NW-stitch the tail beyond the anchor (single_align.c:190-203)
            buflen = 10 + (olen - (ln + seglen))
            if buflen + curpos + seglen > glen:
                buflen = glen - curpos - seglen
            yield from _yield_nw(
                row, ln + seglen, olen - (ln + seglen), 0,
                curpos + seglen, buflen, 0, s,
            )
            s.push("M", seglen)
            break

        if nmisses < 1:
            continue

        # backward extension (single_align.c:212-255)
        while ln > nmisses and ln > 4 and nmisses > 0:
            if use_isa:
                # |pos + seglen - curpos| <= curgap+3 is a positional
                # window query; the service answers it IN the mms
                # dispatch (fused inverse-SA window, batch_exec
                # OP_MEXT) — the minimal in-interval row of the window
                # == the first entry the reference's SA-row scan would
                # accept, at any interval width
                # (test_models.py::test_isa_path_matches_scan_path).
                # All nine curgap attempts depend only on (ln, curpos)
                # at loop entry, so they issue speculatively in "par"
                # chunks of ``isa_spec``; the first acceptable curgap
                # (consumed in sequential order) wins, exactly like
                # the reference's curgap++ loop.
                curgap = 10
                g0 = 1
                while g0 < 10 and curgap == 10:
                    chunk = list(range(g0, min(g0 + max(isa_spec, 1), 10)))
                    g0 = chunk[-1] + 1
                    if len(chunk) == 1:
                        replies = [(yield (
                            "mms_ext", row, 0, ln - chunk[0], curpos,
                            chunk[0],
                        ))]
                    else:
                        replies = yield ("par", [
                            ("mms_ext", row, 0, ln - g, curpos, g)
                            for g in chunk
                        ])
                    for g, (seglen, start, end, wbest) in zip(
                        chunk, replies
                    ):
                        if (start >= end or wbest < 0
                                or abs(wbest + seglen - curpos) - g > 3):
                            continue
                        nmisses -= g
                        pos_k = wbest
                        buflen = curpos - (pos_k + seglen)
                        if buflen < 0:
                            s.push("I", -buflen)
                        else:
                            # ln - curgap can go negative; the original
                            # host path sliced pattern[ln-curgap:ln] with
                            # Python semantics (wraps to the read's tail) —
                            # the reference's pointer arithmetic here is UB
                            # (single_align.c:231), so the Python-slice
                            # behavior is our defined one
                            st = ln - g
                            if st < 0:
                                st += length
                            rl = max(ln - st, 0)
                            yield from _yield_sw(
                                row, st, rl, 0, pos_k + seglen, buflen, 0, s,
                            )
                        s.push("M", seglen)
                        curpos = pos_k
                        ln -= seglen + g
                        curgap = 0
                        break
                if curgap:
                    nmisses = 0
                continue

            curgap = 1
            matched = False
            while curgap < 10:
                seglen, start, end, _pos = yield (
                    "mms", row, 0, ln - curgap,
                )
                base, w = start, CAND_CHUNK
                while base < end and not matched:
                    hi = min(end, base + w)
                    poss = yield ("unc_sa_range", base, hi)
                    base, w = hi, w * 4
                    poss = [int(x) for x in poss]
                    for k in range(len(poss)):
                        pos_k = poss[k]
                        if abs(pos_k + seglen - curpos) - curgap <= 3:
                            nmisses -= curgap
                            matched = True
                            buflen = curpos - (pos_k + seglen)
                            if buflen < 0:
                                s.push("I", -buflen)
                            else:
                                # see the UB note on the isa path above
                                st = ln - curgap
                                if st < 0:
                                    st += length
                                rl = max(ln - st, 0)
                                yield from _yield_sw(
                                    row, st, rl, 0,
                                    pos_k + seglen, buflen, 0, s,
                                )
                            s.push("M", seglen)
                            curpos = pos_k
                            ln -= seglen + curgap
                            curgap = 0
                            break
                if matched:
                    break
                curgap += 1
            if curgap:
                nmisses = 0

        if nmisses > 0:
            # head alignment, reversed strings (single_align.c:256-272)
            buflen = min(ln + 10, curpos)
            x = yield from _yield_nw(
                row, 0, ln, 1, curpos - buflen, buflen, 1, s,
            )
            return curpos - x

        ln -= anchlen
        anchmisses -= anchlen // 10
        s.reset()

    if ln > nmisses or nmisses < 1:
        return 0

    buflen = min(ln + 10, curpos)
    yield from _yield_nw(row, 0, ln, 1, curpos - buflen, buflen, 1, s)
    return curpos - ln  # quirk: ignores the NW endpoint (single_align.c:297)


# --------------------------------------------------------------------------
# Device-resident automaton (phase A of align_reads' device engine)
# --------------------------------------------------------------------------
#
# The whole align_read_anchored control flow (single_align.c:163-298,
# isa path) runs as ONE jitted lax.while_loop: every iteration issues
# one fused service op per live lane (mms for the anchor hunt, mms_ext
# for the backward-extension curgap loop) and advances a vectorized
# phase machine.  DP stitches never feed back into the FM control flow
# (the tail/gap stitch results are only pushed onto the CIGAR; the
# in-loop head endpoint only shapes the RETURN value), so the automaton
# just RECORDS stitch jobs in a fixed per-lane log; phase B replays the
# log through the existing BatchExecutor DP service to build the CIGAR
# — bit-exact reuse of _yield_nw/_yield_sw/Cigar.
#
# Two rare escapes fall back to the host generator (exact by
# construction): log overflow (> _LOGN entries), and the head-return
# quirk where curpos - nw_endpos == 0 reads as "unaligned" and the
# reverse strand must be retried (single_align.c:271 + the driver's
# `if (pos)` check) — only decidable after DP.

# stitch-log entry kinds (phase B replays these in order)
_K_NW, _K_SW, _K_M, _K_I, _K_HEAD = 1, 2, 3, 4, 5
_LOGN = 16
# lane count at which the automaton switches to staged live-lane
# compaction (tests lower it to force the path on small batches)
_COMPACT_AT = 4096


def _compact_ladder(n: int) -> tuple[int, ...]:
    """Geometric compaction thresholds for an n-lane automaton run:
    each stage's while_loop exits once live lanes fit the next 4x
    -smaller width, so per-round gather cost tracks the live count
    down the skew tail instead of paying full width for stragglers.
    Capped at 4 stages (each stage duplicates the loop body in the
    compiled program)."""
    if n < _COMPACT_AT:
        return ()
    floor = max(_COMPACT_AT // 16, 4)  # scales with test overrides
    out = []
    t = n // 4
    while t >= floor and len(out) < 4:
        out.append(t)
        t //= 4
    return tuple(out)

# automaton phases
_A_DONE, _A_ANCH, _A_EXT, _A_HEAD = 0, 1, 2, 3


# test hook: a nonzero value overrides the automatons' iteration cap
# (static jit arg, so monkeypatching creates a fresh specialization) —
# used to force the capped->fallback escape on small batches
_TEST_CAP = 0

# DP bucket shape granule: stitch jobs quantize to (ceil(rlen/G)*G,
# ceil(glen/G)*G) fill shapes.  16 fits the dominant tiny gap-fill /
# short-tail jobs (most are <= 13x16) that a 32-granule padded 4-6x;
# the extra bucket variants cost only compile cache entries, not
# per-chunk dispatch blocking (buckets dispatch async back to back).
_DP_GRAN = 16


@functools.partial(
    jax.jit, static_argnames=("anchor_len", "resolve", "compact",
                              "cap_steps", "seed_k", "spec_anch")
)
def _align_automaton(
    fmi: FMIndex,
    bank: jax.Array,    # (R, Lb) int32; lane k's strands at rows 2k/2k+1
    lens: jax.Array,    # (Bp,) int32 read lengths (0 on pad lanes)
    live0: jax.Array,   # (Bp,) bool
    glen: jax.Array,    # () int32 genome length
    seed_rows=None,     # (4^seed_k, 6) SeedTable rows or None
    *,
    anchor_len: int,
    resolve: bool,
    compact: int = 0,
    cap_steps: int = 0,
    seed_k: int = 0,
    spec_anch: int = 0,
):
    """align_read_anchored + the fwd/rev driver wrapper as one device
    while_loop.  Returns per-lane (mode, curpos, strand, logptr, ovf,
    kinds, roffs, rlens, glens, gstarts, capped):

      mode 0 — unaligned (both strands exhausted; result 0)
      mode 1 — ended at the in-loop head stitch; result is
               curpos - nw_endpos (+1), pending phase B's DP
      mode 2 — head with ln == 0 (the _yield_nw zero-length
               short-circuit); result is curpos (+1), known

    ``capped`` flags lanes still live when the while_loop hit its
    iteration cap (``cap_steps`` override, else 8*Lb + 64): their state
    is mid-flight garbage and phase B routes them to the host-generator
    fallback like the other escapes — no input can silently read as
    "unaligned".  The cap is a safety net: every phase transition
    either consumes >= 1 read character toward a budget (anchor hunt:
    ln -= 3 or ln -= seglen with anchmisses decreasing; ext: curgap++
    to 10 then reset with ln -= anchlen and anchmisses -= anchlen/10)
    or terminates, and both strands run at most once, so the round
    count is O(Lb) with a small constant — 8*Lb + 64 is not reached by
    any known input (the forced-cap test pins the escape anyway).

    The log records (kind, roff, rlen, glen/count, gstart) entries in
    push order; glens carries the count for M/I entries.  A log reset
    (s.reset(), single_align.c:276) just rewinds logptr.

    ``compact`` splits the run into device-side stages: each
    while_loop exits once <= threshold lanes are live (lane finish
    rounds are heavily skewed — p50 ~3, max 2-5x that — so most
    iterations would otherwise pay full-batch service ops for a few
    stragglers), then one argsort + gather packs the live lanes (and
    their bank rows / logs) into a threshold-lane state for the next
    loop, and the results scatter back through the stage chain at the
    end.  No host round trip — this is the device-resident form of the
    live-lane compaction that was rejected in its fetch/re-upload form
    (ROADMAP).  ``compact`` is an int (one stage, the round-2 form) or
    a decreasing tuple of thresholds (k stages: per-round gather cost
    tracks the live-lane count down the skew tail).  Outputs are
    bit-identical for any value — lanes are independent; staging only
    re-partitions them."""
    Bp = lens.shape[0]
    Lb = bank.shape[1]
    slots = jnp.arange(_LOGN, dtype=jnp.int32)[None, :]
    cap = jnp.int32(cap_steps if cap_steps else 8 * Lb + 64)
    olen = lens
    am0 = olen // 10  # anchmisses budget (single_align.c:170)

    def body(s, bank, olen, am0, lane, zeros):
        (it, ph, strand, ln, am, nm, curpos, anchlen, g, lp, mode,
         kinds, roffs, rlens, glens, gstarts, ovf) = s
        rowv = 2 * lane + strand
        is_anch = ph == _A_ANCH
        is_ext = ph == _A_EXT
        is_head = ph == _A_HEAD

        opc = jnp.where(is_anch, OP_MMS,
                        jnp.where(is_ext, OP_MEXT, OP_NONE)).astype(
                            jnp.int32)
        ln_op = jnp.where(is_anch, ln, jnp.where(is_ext, ln - g, 0))
        sp_op = jnp.where(is_ext, curpos, 0)
        ep_op = jnp.where(is_ext, g, 0)
        out = _service_core(
            fmi, bank, opc, rowv, zeros, ln_op, sp_op, ep_op, zeros,
            resolve=resolve, ext=True, with_crank=False,
            seed_rows=seed_rows, seed_k=seed_k,
            spec_anch=spec_anch, anchor_len=anchor_len, am=am,
        )
        seglen = out[_MMS_M]
        osp, oep = out[_OSP], out[_OEP]
        pos, wbest = out[_POS], out[_WBEST]
        if spec_anch:
            # the speculative retry chain consumed some (ln, am) steps
            # inside the service op; the ANCH phase math below runs
            # from the final attempt's state (exactly the C loop's)
            lnA = jnp.where(is_anch, out[13], ln)
            amA = jnp.where(is_anch, out[14], am)
        else:
            lnA, amA = ln, am

        # --- ANCH: one mms of pattern[:ln] (single_align.c:174-189) --
        a_miss = (seglen < anchor_len) | (oep - osp > 1)
        a_hunt = (lnA - 3 > anchor_len) & (amA - 1 > 0)  # retry budget
        a_ln = lnA - seglen
        a_nm = olen // 5
        buflen0 = 10 + (olen - lnA)  # 10 + tail beyond the anchor
        a_buf = jnp.where(buflen0 + pos + seglen > glen,
                          glen - pos - seglen, buflen0)
        a_rlen = olen - lnA
        a_low = a_nm < 1  # olen < 5: `if (nmisses < 1) continue;`
        a_re = (a_ln > anchor_len) & (amA > 0)  # outer re-check, a_low
        a_ext_c = (a_ln > a_nm) & (a_ln > 4)

        # --- EXT: one curgap attempt (single_align.c:224-247) --------
        e_rej = (osp >= oep) | (wbest < 0) | \
            (jnp.abs(wbest + seglen - curpos) - g > 3)
        e_more = g + 1 < 10
        e_nm = nm - g
        e_buf = curpos - (wbest + seglen)
        e_neg = e_buf < 0
        e_st0 = ln - g
        e_st = jnp.where(e_st0 < 0, e_st0 + olen, e_st0)  # UB-pinned wrap
        e_rl = jnp.maximum(ln - e_st, 0)
        e_curpos = wbest
        e_ln = ln - (seglen + g)
        e_ext_c = (e_ln > e_nm) & (e_ln > 4) & (e_nm > 0)

        # --- HEAD: record the head stitch (single_align.c:256-272) ---
        h_buf = jnp.minimum(ln + 10, curpos)

        # --- log writes (<= 2 entries this iteration) ----------------
        a_acc = is_anch & ~a_miss
        e_acc = is_ext & ~e_rej
        w0 = (a_acc & (a_rlen != 0)) | e_acc | (is_head & (ln > 0))
        k0 = jnp.where(is_anch, _K_NW,
                       jnp.where(is_ext,
                                 jnp.where(e_neg, _K_I, _K_SW), _K_HEAD))
        r0 = jnp.where(is_anch, lnA,
                       jnp.where(is_ext, jnp.where(e_neg, 0, e_st), 0))
        l0 = jnp.where(is_anch, a_rlen,
                       jnp.where(is_ext, jnp.where(e_neg, 0, e_rl), ln))
        gl0 = jnp.where(is_anch, jnp.maximum(a_buf, 0),
                        jnp.where(is_ext, jnp.abs(e_buf), h_buf))
        gs0 = jnp.where(is_anch, pos + seglen,
                        jnp.where(is_ext,
                                  jnp.where(e_neg, 0, wbest + seglen),
                                  curpos - h_buf))
        w1 = a_acc | e_acc  # the M push after a stitch
        gl1 = seglen

        s0 = lp
        s1 = lp + w0.astype(jnp.int32)
        m0 = w0[:, None] & (slots == s0[:, None])
        m1 = w1[:, None] & (slots == s1[:, None])

        def put(arr, sel, val):
            return jnp.where(sel, val[:, None].astype(arr.dtype), arr)

        kinds = put(put(kinds, m0, k0), m1, jnp.full_like(k0, _K_M))
        roffs = put(put(roffs, m0, r0), m1, zeros)
        rlens = put(put(rlens, m0, l0), m1, zeros)
        glens = put(put(glens, m0, gl0), m1, gl1)
        gstarts = put(put(gstarts, m0, gs0), m1, zeros)
        lp = lp + w0.astype(jnp.int32) + w1.astype(jnp.int32)
        ovf = ovf | (lp > _LOGN)

        # --- next-state per phase ------------------------------------
        # shared tails: RESET (single_align.c:274-276) and strand fail
        # RESET(x_ln, x_am): ln -= anchlen; anchmisses -= anchlen/10;
        # s.reset(); outer re-check -> ANCH(nm=0) or strand fail
        def reset_from(x_ln, x_am):
            r_ln = x_ln - anchlen
            r_am = x_am - anchlen // 10
            ok = (r_ln > anchor_len) & (r_am > 0)
            return ok, r_ln, r_am

        # ANCH candidates
        ar_ok = a_re  # a_low outer re-check
        a_ph = jnp.where(
            a_miss,
            jnp.where(a_hunt, _A_ANCH, -1),  # -1 = strand fail
            jnp.where(a_low, jnp.where(ar_ok, _A_ANCH, -1),
                      jnp.where(a_ext_c, _A_EXT, _A_HEAD)),
        )
        a_ln2 = jnp.where(a_miss, lnA - 3, a_ln)
        a_am2 = jnp.where(a_miss, amA - 1, amA)
        a_nm2 = jnp.where(a_miss | a_low, 0, a_nm)
        a_cp2 = jnp.where(a_miss, curpos, pos)
        a_al2 = jnp.where(a_miss, anchlen, seglen)

        # EXT candidates
        er_ok, er_ln, er_am = reset_from(ln, am)       # reject exhaust
        es_ok, es_ln, es_am = reset_from(e_ln, am)     # accept, nm<=0
        e_ph = jnp.where(
            e_rej,
            jnp.where(e_more, _A_EXT,
                      jnp.where(er_ok, _A_ANCH, -1)),
            jnp.where(e_ext_c, _A_EXT,
                      jnp.where(e_nm > 0, _A_HEAD,
                                jnp.where(es_ok, _A_ANCH, -1))),
        )
        e_reset = (e_rej & ~e_more) | (~e_rej & ~e_ext_c & (e_nm <= 0))
        e_ln2 = jnp.where(
            e_rej, jnp.where(e_more, ln, er_ln),
            jnp.where(e_ext_c | (e_nm > 0), e_ln, es_ln),
        )
        e_am2 = jnp.where(e_rej & ~e_more, er_am,
                          jnp.where(e_reset & ~e_rej, es_am, am))
        e_nm2 = jnp.where(e_rej, jnp.where(e_more, nm, 0),
                          jnp.where(e_reset, 0, e_nm))
        e_cp2 = jnp.where(e_rej, curpos, e_curpos)
        e_g2 = jnp.where(e_rej & e_more, g + 1, 1)

        # HEAD candidates: ln == 0 short-circuits to a known result
        h_ph = jnp.where(ln > 0, _A_DONE,
                         jnp.where(curpos != 0, _A_DONE, -1))
        h_mode = jnp.where(ln > 0, 1, jnp.where(curpos != 0, 2, 0))

        ph2 = jnp.where(is_anch, a_ph,
                        jnp.where(is_ext, e_ph,
                                  jnp.where(is_head, h_ph, ph)))
        ln2 = jnp.where(is_anch, a_ln2,
                        jnp.where(is_ext, e_ln2, ln))
        am2 = jnp.where(is_anch, a_am2, jnp.where(is_ext, e_am2, am))
        nm2 = jnp.where(is_anch, a_nm2, jnp.where(is_ext, e_nm2, nm))
        cp2 = jnp.where(is_anch, a_cp2, jnp.where(is_ext, e_cp2, curpos))
        al2 = jnp.where(is_anch, a_al2, anchlen)
        g2 = jnp.where(is_anch, jnp.where(a_ph == _A_EXT, 1, g),
                       jnp.where(is_ext, e_g2, g))
        mode2 = jnp.where(is_head, h_mode, mode)
        lp2 = jnp.where(is_ext & e_reset, 0, lp)
        ovf2 = jnp.where(is_ext & e_reset, False, ovf)

        # strand fail (-1): fwd -> reinit on the reverse row; rev -> done
        fail = ph2 == -1
        to_rev = fail & (strand == 0)
        ph2 = jnp.where(fail, jnp.where(to_rev, _A_ANCH, _A_DONE), ph2)
        # reverse strand only runs when the entry condition holds
        # (olen > anchor_len and olen//10 > 0 — same as the fwd entry)
        can = (olen > anchor_len) & (am0 > 0)
        ph2 = jnp.where(to_rev & ~can, _A_DONE, ph2)
        strand2 = jnp.where(to_rev, 1, strand)
        ln2 = jnp.where(to_rev, olen, ln2)
        am2 = jnp.where(to_rev, am0, am2)
        nm2 = jnp.where(to_rev, 0, nm2)
        cp2 = jnp.where(to_rev, -1, cp2)
        al2 = jnp.where(to_rev, 0, al2)
        g2 = jnp.where(to_rev, 0, g2)
        lp2 = jnp.where(to_rev, 0, lp2)
        ovf2 = jnp.where(to_rev, False, ovf2)
        mode2 = jnp.where(fail & ~to_rev, 0, mode2)

        return (it + 1, ph2.astype(jnp.int32), strand2, ln2, am2, nm2,
                cp2, al2, g2, lp2, mode2,
                kinds, roffs, rlens, glens, gstarts, ovf2)

    def cond(s):
        return (s[0] < cap) & jnp.any(s[1] != _A_DONE)

    def stage(bank, olen, am0):
        n = olen.shape[0]
        lane = jnp.arange(n, dtype=jnp.int32)
        zeros = jnp.zeros((n,), jnp.int32)
        return lambda s: body(s, bank, olen, am0, lane, zeros)

    zeros = jnp.zeros((Bp,), jnp.int32)
    can0 = live0 & (olen > anchor_len) & (am0 > 0)
    ph0 = jnp.where(can0, _A_ANCH, _A_DONE).astype(jnp.int32)
    state = (
        jnp.int32(0), ph0, zeros, olen, am0, zeros,
        jnp.full((Bp,), -1, jnp.int32), zeros, zeros, zeros, zeros,
        jnp.zeros((Bp, _LOGN), jnp.int8),
        jnp.zeros((Bp, _LOGN), jnp.int16),
        jnp.zeros((Bp, _LOGN), jnp.int16),
        jnp.zeros((Bp, _LOGN), jnp.int16),
        jnp.zeros((Bp, _LOGN), jnp.int32),
        jnp.zeros((Bp,), bool),
    )
    thresholds = (compact,) if isinstance(compact, int) else tuple(compact)
    thresholds = tuple(t for t in thresholds if t)
    cur_state, cur_bank, cur_olen, cur_am0 = state, bank, olen, am0
    trail = []  # (pre-compaction state, live-lane perm) per stage
    for th in thresholds:
        s1 = jax.lax.while_loop(
            lambda s, _th=th: cond(s) & (
                jnp.sum((s[1] != _A_DONE).astype(jnp.int32)) > _th
            ),
            stage(cur_bank, cur_olen, cur_am0), cur_state,
        )
        # live lanes first (any order works: results return by index)
        perm = jnp.argsort((s1[1] == _A_DONE).astype(jnp.int32))[:th]
        trail.append((s1, perm))
        cur_state = (s1[0],) + tuple(x[perm] for x in s1[1:])
        rows = (2 * perm[:, None]
                + jnp.arange(2, dtype=perm.dtype)[None, :]).reshape(-1)
        cur_bank = cur_bank[rows]
        cur_olen = cur_olen[perm]
        cur_am0 = cur_am0[perm]
    final = jax.lax.while_loop(
        cond, stage(cur_bank, cur_olen, cur_am0), cur_state)
    for s1, perm in reversed(trail):
        final = (final[0],) + tuple(
            f.at[perm].set(c) for f, c in zip(s1[1:], final[1:]))
    (it_f, ph_f, strand, _, _, _, curpos, _, _, lp, mode,
     kinds, roffs, rlens, glens, gstarts, ovf) = final
    capped = ph_f != _A_DONE
    # iters: the cumulative while-iteration count across compaction
    # stages, broadcast per-lane so the mesh path's P('dp') out-spec
    # still applies (profiling only; phase B never fetches it)
    return (mode, curpos, strand, lp, ovf,
            kinds, roffs, rlens, glens, gstarts, capped,
            jnp.full((Bp,), it_f, jnp.int32))


def _align_automaton_mesh(mesh, fmi, bank, lens, live0, glen, seed=None, *,
                          anchor_len, resolve, compact, cap_steps=0):
    """Data-parallel phase A: the automaton under ``shard_map`` over
    the mesh's 'dp' axis — bank rows / lane state shard across chips.
    With a replicated index (``fmi.tp_axis`` None) every gather is
    local and each shard runs the full while_loop with ZERO
    collectives; with a tp view (>HBM indexes) the SAME traced program
    resolves each rank as a local-block gather + one (…, 8) psum over
    'tp' (lanes replicate within a tp group, so the loop stays
    collectively consistent and still exits per-dp-shard early).
    Outputs are bit-identical to the single-device automaton — lanes
    are independent; sharding only partitions them
    (tests/test_parallel.py pins both on the 8-device CPU mesh)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from bwt_tpu.parallel.mesh import _shard_map, fmi_spec_tree

    seed_k = 0 if seed is None else seed.k
    inner = functools.partial(
        _align_automaton, anchor_len=anchor_len, resolve=resolve,
        compact=compact, cap_steps=cap_steps, seed_k=seed_k,
    )
    if seed is None:
        f = _shard_map(
            lambda fmi_, b, l, v, g: inner(fmi_, b, l, v, g),
            mesh,
            in_specs=(fmi_spec_tree(fmi), P("dp", None), P("dp"),
                      P("dp"), P()),
            out_specs=P("dp"),
            check=False,
        )
        extra = ()
    else:
        f = _shard_map(
            lambda fmi_, b, l, v, g, sr: inner(fmi_, b, l, v, g, sr),
            mesh,
            in_specs=(fmi_spec_tree(fmi), P("dp", None), P("dp"),
                      P("dp"), P(), P()),  # seed rows replicate
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
        glen,
        *extra,
    )


def _assemble_logs(svc, n, mode, curpos, strand, lp, ovf,
                   kinds, roffs, rlens, glens, gstarts, capped=None,
                   lanes=None):
    """Phase B, fully vectorized: run every log's DP jobs via
    :func:`~bwt_tpu.models.batch_exec.dp_jobs_blocks` (one dispatch per
    shape bucket), then compose each read's CIGAR with flat numpy —
    NW/HEAD run blocks reversed (the Cigar flip, smw.c:99-111; stack.c:
    51-59), M/I log pushes interleaved in order, and one global
    adjacent-equal-op merge (push-merge semantics are associative over
    adjacency, so merging once at the end equals the generator's nested
    merges).  Replaces a per-read Python replay that cost ~1.2 s per
    32 k reads.

    Returns (results, fallback): results[k] = (pos, Cigar, rev) /
    (0, None, False), or None for reads needing the host-generator
    fallback (log overflow; lanes capped mid-flight by the automaton's
    iteration bound; the head-on-zero strand-retry quirk of
    single_align.c:271).

    ``lanes`` (optional): original bank-lane index per row, when the
    input arrays are a SUBSET of the automaton batch (the fused path's
    run-overflow redo) — DP jobs then read bank rows 2*lanes[k] +
    strand instead of 2*k + strand."""
    from bwt_tpu.models.batch_exec import _OP_CHARS, dp_jobs_blocks

    mode, curpos, strand, lp = (
        np.asarray(x)[:n] for x in (mode, curpos, strand, lp)
    )
    ovf = np.asarray(ovf)[:n]
    if capped is not None:
        # a capped lane's state is mid-flight garbage — escape it like
        # ovf (its log must not feed DP jobs either)
        ovf = ovf | np.asarray(capped)[:n]
    kinds, roffs, rlens, glens, gstarts = (
        np.asarray(x)[:n] for x in (kinds, roffs, rlens, glens, gstarts)
    )
    slot = np.arange(_LOGN)[None, :]
    # overflow / unaligned / already-known lanes never replay
    active = (mode != 0) & ~ovf
    vmask = active[:, None] & (slot < np.minimum(lp, _LOGN)[:, None])
    jobmask = vmask & (
        (kinds == _K_NW) | (kinds == _K_SW) | (kinds == _K_HEAD)
    )
    jk, jt = np.nonzero(jobmask)  # row-major == per-read log order
    head_end = np.zeros(n, np.int32)
    if jk.size:
        jkind = kinds[jk, jt]
        is_head = jkind == _K_HEAD
        is_sw = jkind == _K_SW
        jlane = jk if lanes is None else np.asarray(lanes)[jk]
        endpos, blk_ops, blk_cnt, blk_len = dp_jobs_blocks(
            svc,
            (2 * jlane + strand[jk]).astype(np.int32),
            roffs[jk, jt].astype(np.int32),
            rlens[jk, jt].astype(np.int32),
            is_head.astype(np.int32),
            gstarts[jk, jt].astype(np.int32),
            glens[jk, jt].astype(np.int32),
            is_head.astype(np.int32),
            (~is_sw).astype(np.int32),
        )
        # the Cigar flip: NW/HEAD blocks are consumed top-first
        Wb = blk_ops.shape[1]
        tb = np.arange(Wb)[None, :]
        nwj = np.nonzero(~is_sw)[0]
        if nwj.size:
            bl = blk_len[nwj][:, None]
            idx = np.where(tb < bl, np.maximum(bl - 1 - tb, 0), tb)
            blk_ops[nwj] = np.take_along_axis(blk_ops[nwj], idx, 1)
            blk_cnt[nwj] = np.take_along_axis(blk_cnt[nwj], idx, 1)
        head_end[jk[is_head]] = endpos[is_head]
    else:
        Wb = 1
        blk_ops = np.zeros((0, 1), np.int8)
        blk_cnt = np.zeros((0, 1), np.int32)

    # compose: (read, slot, run) -> flat run stream in log order
    big_o = np.full((n, _LOGN, Wb), -1, np.int8)
    big_c = np.zeros((n, _LOGN, Wb), np.int32)
    mm = vmask & (kinds == _K_M)
    im = vmask & (kinds == _K_I)
    big_o[..., 0] = np.where(mm, 0, np.where(im, 1, -1))
    big_c[..., 0] = np.where(mm | im, glens, 0)
    if jk.size:
        big_o[jk, jt] = blk_ops
        big_c[jk, jt] = blk_cnt
    flat_o = big_o.reshape(n, -1)
    flat_c = big_c.reshape(n, -1)
    keep = flat_o >= 0  # count-0 runs stay: the C stack prints "0M"
    read_of = np.broadcast_to(
        np.arange(n)[:, None], flat_o.shape
    )[keep]
    so = flat_o[keep]
    sc = flat_c[keep]
    if so.size:
        new = np.empty(so.size, bool)
        new[0] = True
        new[1:] = (so[1:] != so[:-1]) | (read_of[1:] != read_of[:-1])
        rid = np.cumsum(new) - 1
        csum = np.bincount(rid, weights=sc).astype(np.int64).tolist()
        rops = so[new].tolist()
        bounds = np.searchsorted(read_of[new], np.arange(n + 1))
    else:
        csum, rops, bounds = [], [], np.zeros(n + 1, np.int64)

    res = np.where(mode == 2, curpos,
                   np.where(mode == 1, curpos - head_end, 0))
    ml = mode.tolist()
    rl = res.tolist()
    sl = strand.tolist()
    results: list = [None] * n
    fallback: list[int] = []
    for k in range(n):
        if ovf[k]:
            fallback.append(k)
        elif ml[k] == 0:
            results[k] = (0, None, False)
        elif rl[k] == 0:
            fallback.append(k)  # head landed exactly on 0: retry quirk
        else:
            c = Cigar()
            c.ops = [
                [_OP_CHARS[rops[q]], csum[q]]
                for q in range(bounds[k], bounds[k + 1])
            ]
            results[k] = (rl[k] + 1, c, sl[k] == 1)
    return results, fallback


# --------------------------------------------------------------------------
# Fused (device-side) phase B
# --------------------------------------------------------------------------
#
# The host phase B above fetches the full per-lane stitch logs (~190
# B/lane) plus per-job RLE runs (~60 B/job).  The fused path keeps the
# log ON DEVICE: the host fetches only what DP bucketing needs
# (kinds/rlens/glens + per-lane scalars), each bucket's DP jobs gather
# their own parameters from the device log, run blocks scatter back
# device-side, and one compose kernel merges every lane's run stream —
# so the final fetch is the finished (lane, _RUNS_K) CIGAR runs.
# Outputs are bit-identical to the host path (same jobs, same block
# semantics, same adjacent-merge; test_models pins both); reads whose
# device-RLE or merged stream overflows the fixed widths take the
# host-generator fallback.

# merged CIGAR runs per read kept on the fast path.  K balances fetch
# width against redo volume; 16 covers every lane the 1 Mb / 32 k
# mutated-read profile produces for ~190 KB more fetch (~5 ms).  (The
# same profile also needed _RLE_R=48 and F2=64 — at the old 32/32
# widths 88 lanes/chunk took the ~0.1 s host redo, the largest
# phase-B term after the DP wait.)
_RUNS_K = 16
_FUSED_ASSEMBLE = True  # module switch for A/B and the mesh path


@functools.partial(
    jax.jit, static_argnames=("L1", "L2", "scoring"),
    # the chunk-wide accumulators (runs_oc..over, ~70 MB at 32k lanes)
    # are dead after each bucket call: donate so XLA aliases them
    # instead of materializing fresh outputs per bucket
    donate_argnums=(10, 11, 12, 13),
)
def _dp_scatter_bucket(
    bank, genome, strand, kinds, roffs, rlens, glens, gstarts,
    jk, jt, runs_oc, bl3, head_end, over,
    *, L1: int, L2: int, scoring=None,
):
    """One DP shape bucket of the fused phase B: gather the bucket's
    job parameters from the device-resident stitch log, run the batched
    DP (:func:`~bwt_tpu.models.batch_exec._dp_core`), build the run
    blocks device-side and scatter them into the chunk-wide
    accumulators.  Pad jobs carry ``jk == n`` (out of range): their
    gathers clamp to lane n-1 (garbage, unused) and their scatters
    drop."""
    from bwt_tpu.models.batch_exec import _dp_blocks_core, _dp_core

    n = head_end.shape[0]
    jkc = jnp.clip(jk, 0, n - 1)
    valid = jk < n
    kj = kinds[jkc, jt].astype(jnp.int32)
    is_head = kj == _K_HEAD
    is_sw = kj == _K_SW
    out = _dp_core(
        bank, genome,
        2 * jkc + strand[jkc],
        roffs[jkc, jt].astype(jnp.int32),
        rlens[jkc, jt].astype(jnp.int32),
        is_head.astype(jnp.int32),
        gstarts[jkc, jt],
        glens[jkc, jt].astype(jnp.int32),
        is_head.astype(jnp.int32),
        (~is_sw).astype(jnp.int32),
        L1=L1, L2=L2, scoring=scoring,
    )
    maxloc, i_res, j_res, nrun, vals, counts, _ops = out
    bo, bc, bl, ov = _dp_blocks_core(
        maxloc, i_res, j_res, nrun, vals, counts, ~is_sw
    )
    # ONE packed (op+2)<<24 | count accumulator instead of separate
    # op/count arrays: halves the scatter here and the compose's
    # stream gather + merge scatter (measured ~64 ms of compose per
    # 32 k chunk before packing).  Bit budget: op+2 in {1..4} above
    # bit 24; pre-merge counts <= Lb + 10 and adjacent-merge sums over
    # <= F2 entries stay far below 2^24 (reads cap at 64 KiB,
    # single_align.c:369), so count carries never reach the op field.
    runs_oc = runs_oc.at[jk, jt].set(
        ((bo + 2) << 24) | bc, mode="drop")
    bl3 = bl3.at[jk, jt].set(bl, mode="drop")
    head_end = head_end.at[jk].add(
        jnp.where(is_head & valid, maxloc - 1, 0), mode="drop"
    )
    over = over.at[jk].max(
        (ov & valid).astype(jnp.int32), mode="drop"
    )
    return runs_oc, bl3, head_end, over


@functools.partial(jax.jit, static_argnames=("K",))
def _compose_device(kinds, glens, lp, mode, curpos, head_end,
                    runs_oc, bl3, strand=None, over_rle=None,
                    *, K=_RUNS_K):
    """Merge every lane's stitch-log run stream on device — the
    vectorized-numpy composition of :func:`_assemble_logs` as one
    kernel.  M/I log entries contribute singleton runs; job slots
    contribute their scattered blocks; entries concatenate in log
    order (offs = exclusive prefix over per-slot lengths) and one
    adjacent-equal-op merge produces the final (lane, _RUNS_K) runs.
    Count-0 runs are kept (the C stack prints "0M").  Returns
    (ops int8, counts int16, nrun int16 (K+1 = overflow), res, over)
    where ``res`` is the per-lane return value (mode 2: curpos;
    mode 1: curpos - head NW endpoint; else 0).

    ``runs_oc`` carries (op+2)<<24 | count packed (see
    :func:`_dp_scatter_bucket`): the stream pack gathers ONE array and
    the run merge scatters ONE array — these four ops were the
    dominant compose cost unpacked."""
    n, LOGN, W = runs_oc.shape
    slot = jnp.arange(LOGN, dtype=jnp.int32)[None, :]
    vmask = slot < jnp.minimum(lp, LOGN)[:, None]
    k32 = kinds.astype(jnp.int32)
    mm = vmask & (k32 == _K_M)
    im = vmask & (k32 == _K_I)
    single = mm | im
    # singleton M/I entries: op M=0 -> packed 2<<24, I=1 -> 3<<24
    runs_oc = runs_oc.at[:, :, 0].set(
        jnp.where(single,
                  (jnp.where(mm, 2, 3) << 24) | glens.astype(jnp.int32),
                  runs_oc[:, :, 0])
    )
    bl = jnp.where(single, 1, jnp.where(vmask, bl3, 0))
    offs = jnp.cumsum(bl, axis=1) - bl
    cnt = offs[:, -1] + bl[:, -1]

    # pack the per-slot run blocks into one (n, F2) stream by GATHER:
    # the former scatter over an (n, LOGN*W) frame was the slow path
    # on the earlier accelerator (unmeasured on the H100); instead each of
    # the F2 output positions reads its source (slot, w) — slot(p) =
    # largest s with offs[s] <= p (zero-length slots collapse), wi =
    # p - offs[slot].  F2 caps the pre-merge run count per lane
    # (measured totals <= ~20: log <= 16 entries, DP blocks almost
    # always 1-3 runs); a lane past the cap raises the overflow flag
    # -> bit-exact host fallback.
    F2 = 48
    p = jnp.arange(F2, dtype=jnp.int32)
    sle = offs[:, :, None] <= p[None, None, :]          # (n, LOGN, F2)
    sel = jnp.sum(sle.astype(jnp.int32), axis=1) - 1    # (n, F2)
    selc = jnp.clip(sel, 0, LOGN - 1)
    wi = p[None, :] - jnp.take_along_axis(offs, selc, axis=1)
    src = selc * W + jnp.clip(wi, 0, W - 1)
    inr = p[None, :] < cnt[:, None]
    soc = jnp.where(inr, jnp.take_along_axis(
        runs_oc.reshape(n, LOGN * W), src, axis=1), 1 << 24)
    so = (soc >> 24) - 2   # ops; -1 on padding (packed 1<<24)
    sc = soc & 0xFFFFFF
    over_pack = cnt > F2

    prev = jnp.concatenate(
        [jnp.full((n, 1), -2, jnp.int32), so[:, :-1]], 1
    )
    pos2 = p[None, :]
    new = inr & ((pos2 == 0) | (so != prev))
    rid = jnp.cumsum(new.astype(jnp.int32), axis=1) - 1
    nrunm = jnp.max(jnp.where(inr, rid, -1), axis=1) + 1
    rows2 = jnp.arange(n, dtype=jnp.int32)[:, None]
    ok = inr & (rid < K)
    tgt2 = jnp.where(ok, rows2 * K + rid, n * K)
    # one packed scatter-add: each rid's single `new` entry contributes
    # the op field (op+2)<<24, every entry adds its count — count sums
    # stay below 2^24 (see _dp_scatter_bucket), so no carry reaches op
    pk = jnp.where(new & ok, (so + 2) << 24, 0) + jnp.where(ok, sc, 0)
    fpk = jnp.zeros((n * K,), jnp.int32).at[tgt2.ravel()].add(
        pk.ravel(), mode="drop").reshape(n, K)
    fo = jnp.where(fpk != 0, (fpk >> 24) - 2, -1)
    fc = fpk & 0xFFFFFF
    res = jnp.where(mode == 2, curpos,
                    jnp.where(mode == 1, curpos - head_end, 0))
    # adjacent-equal merges sum int32 counts; the host path composes in
    # int64, so a merged count past int16 must take the fallback rather
    # than wrap in the .astype(int16) below (same class as the
    # _rle_device overflow guard)
    over_cnt = jnp.any(fc > 32767, axis=1) | over_pack
    outs = (fo.astype(jnp.int8), fc.astype(jnp.int16),
            jnp.minimum(nrunm, K + 1).astype(jnp.int16), res,
            ((nrunm > K) | over_cnt).astype(jnp.int8))
    if strand is None:
        return outs
    # fetch-width casts ride the same kernel (a stray .astype outside
    # jit is its own dispatch)
    return outs + (over_rle.astype(jnp.int8), strand.astype(jnp.int8),
                   mode.astype(jnp.int8))


@jax.jit
def _pack_fetch(fo, fc, nrunm, res, overm, over_rle, strand, mode,
                ovf, capped, olens):
    """Squeeze the per-lane result fetch to ~6 B/lane (from 59 B):
    device->host bytes on the aligner's critical path.

    Per lane, always fetched:
      res   int32 — genome positions need the width
      meta  uint8 — mode(2) | strand<<2 | rle<<3 | m<<4 | ovf<<5 |
            capped<<6 | fc8-overflow<<7
      nm1   uint8 — run count | pure-M<<7.  A lane whose whole CIGAR
            merged to one M run covering the read (the typical clean
            or substitution-only alignment — frequently ~100% of a
            batch) is fully described by its read length, which the
            host already has: no run data travels for it.
    Exceptional (non-pure, renderable) lanes compact into a static
    E-capacity side channel (lane ids + packed ops + uint8 counts).
    If more than E lanes are exceptional, the host falls back to
    fetching the full per-lane run arrays (returned un-copied as
    ``big``) — correctness never depends on the capacity.
    Lanes with > 8 runs or a count > 254 set the redo bit (host
    re-compose, bit-exact — same path as the compose-width overflows).
    """
    n, K = fo.shape
    E = min(max(n // 8, 64), n)
    shifts = (2 * jnp.arange(K, dtype=jnp.uint32))[None, :]
    fo_packed = jnp.sum(
        ((fo.astype(jnp.int32) + 1).astype(jnp.uint32) & 3) << shifts,
        axis=1, dtype=jnp.uint32,
    )
    fc32 = fc.astype(jnp.int32)
    over_fc = (nrunm.astype(jnp.int32) > 8) | \
        jnp.any(fc32[:, :8] > 254, axis=1)
    fc8 = jnp.clip(fc32[:, :8], 0, 255).astype(jnp.uint8)
    badrv = (over_rle.astype(jnp.int32) > 0) | \
        (overm.astype(jnp.int32) > 0)
    meta = (
        mode.astype(jnp.int32)
        | (strand.astype(jnp.int32) << 2)
        | ((over_rle.astype(jnp.int32) > 0).astype(jnp.int32) << 3)
        | ((overm.astype(jnp.int32) > 0).astype(jnp.int32) << 4)
        | (ovf.astype(jnp.int32) << 5)
        | (capped.astype(jnp.int32) << 6)
        | (over_fc.astype(jnp.int32) << 7)
    ).astype(jnp.uint8)
    # pure-M: exactly one run, op M, count == the read length (checked
    # on device so the host's "{len}M" render is exact by construction)
    pure = (nrunm.astype(jnp.int32) == 1) & (fo[:, 0] == 0) & \
        (fc32[:, 0] == olens)
    # a pure lane can't be fc8-overflowing, but keep the flag coherent
    pure = pure & ~over_fc
    ok = (mode.astype(jnp.int32) != 0) & (capped.astype(jnp.int32) == 0) \
        & (ovf.astype(jnp.int32) == 0) & ~badrv & ~over_fc & (res != 0)
    sel = ok & ~pure
    n_excl = jnp.sum(sel.astype(jnp.int32))
    lane = jnp.argsort(~sel).astype(jnp.int32)[:E]  # stable: sel first
    in_cap = jnp.arange(E, dtype=jnp.int32) < n_excl
    excl_idx = jnp.where(in_cap, lane, -1)
    lc = jnp.clip(lane, 0, n - 1)
    excl_fo = jnp.take(fo_packed, lc)
    excl_fc = jnp.take(fc8, lc, axis=0)
    nm1 = (
        jnp.minimum(nrunm.astype(jnp.int32), K + 1)
        | (pure.astype(jnp.int32) << 7)
    ).astype(jnp.uint8)
    small = (res, meta, nm1, excl_idx, excl_fo, excl_fc,
             n_excl[None])
    return small, (fo_packed, fc8)


@functools.partial(jax.jit, static_argnames=("NB", "NL2"))
def _job_bucket_sort(mode, lp, ovf, kinds, rlens, glens, *, NB, NL2):
    """Device-side DP-shape bucketing of the stitch-log jobs: returns
    (order, counts) where ``order`` lists the flat job ids (lane *
    _LOGN + slot) sorted by shape-bucket id (invalid slots last) and
    ``counts[b]`` is bucket b's job count.  Bucket b = (l1-1)*NL2 +
    (l2-1) with l1/l2 = ceil(len/32) — exactly
    :func:`~bwt_tpu.models.batch_exec.dp_shape`'s (32*l1, 32*l2)
    signature grid.  Replaces a ~2.8 MB host fetch of the log arrays
    (the former phase-B fetch 1) with a ~100 B counts fetch."""
    LOGN = kinds.shape[1]
    slot = jnp.arange(LOGN, dtype=jnp.int32)[None, :]
    vmask = ((mode != 0) & ~ovf)[:, None] & (
        slot < jnp.minimum(lp, LOGN)[:, None]
    )
    k32 = kinds.astype(jnp.int32)
    isjob = vmask & ((k32 == _K_NW) | (k32 == _K_SW) | (k32 == _K_HEAD))
    l1 = jnp.maximum(1, -(-rlens.astype(jnp.int32) // _DP_GRAN))
    l2 = jnp.maximum(1, -(-glens.astype(jnp.int32) // _DP_GRAN))
    bid = jnp.where(isjob, (l1 - 1) * NL2 + (l2 - 1), NB).reshape(-1)
    order = jnp.argsort(bid).astype(jnp.int32)
    counts = jnp.bincount(bid, length=NB + 1)[:NB].astype(jnp.int32)
    offs = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(counts)]
    )
    return order, counts, offs


@functools.partial(jax.jit, static_argnames=("J",))
def _bucket_ids(order, offset, count, sentinel, *, J):
    """Slice one bucket's (jk, jt) job lists (static capacity ``J``;
    pad entries carry ``jk == sentinel`` so their scatters drop).
    ``offset``/``count`` may be host ints (the exact path) or DEVICE
    scalars (the speculative path, which slices ``offs[b]``/
    ``counts[b]`` without ever fetching them — the counts round-trip
    was a ~0.1 s/chunk host stall).  ``count > J`` jobs are silently
    dropped here; the speculative caller detects that from the async
    counts and re-dispatches exactly."""
    idx = offset + jnp.arange(J, dtype=jnp.int32)
    ids = jnp.take(order, jnp.minimum(idx, order.shape[0] - 1))
    valid = jnp.arange(J, dtype=jnp.int32) < count
    jk = jnp.where(valid, ids // _LOGN, sentinel)
    jt = jnp.where(valid, ids % _LOGN, 0)
    return jk, jt


def _cap_for(c: int) -> int:
    """Static DP capacity for an expected bucket count: plain pow2 —
    STABLE across chunks (a moving grid made every chunk a fresh
    (L1, L2, J) compile).  A chunk whose count crosses the boundary
    takes the exact-retry path once."""
    from bwt_tpu.models.batch_exec import _pow2

    return _pow2(max(c, 1))


# cross-call DP-bucket plan memo: the exact path must BLOCK on this
# chunk's bucket counts (a host sync that also waits out all queued
# device work) before it can dispatch the DP buckets.  Whether that
# stall still pays for this memo on the H100 is unmeasured (ROADMAP
# queue 1).  The job-shape mix is stable across chunks AND calls of the
# same workload, so the last plan seen for a (Bp, Lb) shape seeds
# speculative dispatch of the next call's first chunks; a plan that
# undershoots re-dispatches exactly (_assemble_fetch's overflow check),
# so a stale entry costs one retry and never correctness.
_PLAN_MEMO: dict = {}


def _merge_plan(old, new):
    """Union of two bucket plans with per-bucket max capacity.  Plans
    must only GROW across chunks/calls: a speculative dispatch whose
    cap undershoots re-dispatches exactly — and under the chunk
    pipeline that retry queues BEHIND the following chunks' automatons
    (measured ~0.3 s per retry at 1 Mb), so one pow2 of padding on a
    small bucket is far cheaper than one miss.  Buckets present in the
    plan but empty in a given chunk scatter nothing (their job ids are
    all sentinel)."""
    caps: dict = {}
    for plan in (old, new):
        if plan:
            for b, _c, cap in plan:
                caps[b] = max(caps.get(b, 0), cap)
    return [(b, 0, caps[b]) for b in sorted(caps)]


def _assemble_logs_fused(svc, n, out):
    """Phase B with the stitch log kept on device (see the section
    comment).  Same (results, fallback) contract as
    :func:`_assemble_logs`.  Host traffic is two slim transfers: the
    bucket counts (~100 B) and the finished per-lane runs/scalars
    (~25 B/lane) — everything between (job bucketing, DP, run
    composition) stays device-resident.  Split into a device half and
    a host half so the chunk pipeline can run them one stage apart."""
    Bp = int(out[3].shape[0])
    key = (Bp, int(svc.bank.shape[1]))
    bctx = _assemble_dispatch(svc, n, out, plan=_PLAN_MEMO.get(key))
    res = _assemble_fetch(svc, n, bctx)
    cd = np.asarray(bctx[3])  # true counts (ready: results are)
    _PLAN_MEMO[key] = _merge_plan(
        _PLAN_MEMO.get(key),
        [(int(b), int(cd[b]), _cap_for(int(cd[b])))
         for b in np.nonzero(cd)[0]],
    )
    return res


def _assemble_dispatch(svc, n, out, plan=None):
    """Device half of the fused phase B: DP-bucket the stitch-log jobs,
    compose the run streams, and start the slim result fetch
    asynchronously.  Returns the context :func:`_assemble_fetch`
    consumes.  ``plan`` (list of (bucket, expected_count, capacity)):
    dispatch speculatively with the previous chunk's bucket plan
    instead of blocking on this chunk's counts."""
    from bwt_tpu.models.batch_exec import _OP_CHARS, _RLE_R, _pow2

    (mode_d, curpos_d, strand_d, lp_d, ovf_d,
     kinds_d, roffs_d, rlens_d, glens_d, gstarts_d, capped_d) = out[:11]
    Bp = int(lp_d.shape[0])
    bank = svc._ensure_bank()
    Lb = int(bank.shape[1])
    # genome spans in the log are bounded by Lb + 10 (NW: 10 + tail,
    # HEAD: min(ln + 10, curpos), SW: |e_buf| <= curgap + 3 <= 13)
    NL1 = -(-Lb // _DP_GRAN)
    NL2 = -(-(Lb + 10) // _DP_GRAN)
    with _span("B.bucket_sort+counts"):
        if len(out) > 12:  # pre-dispatched at launch (async counts)
            order_d, counts_d, offs_d, lens_d = out[12]
        else:
            order_d, counts_d, offs_d = _job_bucket_sort(
                mode_d, lp_d, ovf_d, kinds_d, rlens_d, glens_d,
                NB=NL1 * NL2, NL2=NL2,
            )
            lens_d = jnp.asarray(svc.read_lengths())
            if lens_d.shape[0] < Bp:
                lens_d = jnp.concatenate(
                    [lens_d, jnp.zeros((Bp - lens_d.shape[0],),
                                       jnp.int32)])
        if plan is None:
            # exact path: block on the true counts (chunk 0 of a
            # pipeline, the mono path, and speculative-overflow retries)
            counts = np.asarray(jax.device_get(counts_d))
            plan_used = [(int(b), int(counts[b]), _pow2(int(counts[b])))
                         for b in np.nonzero(counts)[0]]
            exact = True
        else:
            # speculative path: dispatch with the PREVIOUS chunk's
            # bucket plan — offsets/counts slice on device, so no
            # host round-trip blocks behind the automaton.  A bucket
            # that outgrows its capacity (or appears from nowhere) is
            # detected from the async counts at fetch time and the
            # whole phase B re-dispatches exactly (rare: chunk-to
            # -chunk job mixes vary well under _cap_for's headroom).
            plan_used = plan
            exact = False

    Wb = _RLE_R + 2  # block width, matches _dp_blocks_core
    with _span("B.prep_zeros"):
        runs_oc = jnp.zeros((Bp, _LOGN, Wb), jnp.int32)
        bl3 = jnp.zeros((Bp, _LOGN), jnp.int32)
        head_end = jnp.zeros((Bp,), jnp.int32)
        over = jnp.zeros((Bp,), jnp.int32)

    with _span("B.dp_buckets"):
        for b, _c, cap in plan_used:
            l1, l2 = divmod(int(b), NL2)
            with _span(f"B.dp_bucket_{_DP_GRAN * (l1 + 1)}"
                       f"x{_DP_GRAN * (l2 + 1)}_J{cap}"):
                jkp, jtp = _bucket_ids(
                    order_d, offs_d[b], counts_d[b], np.int32(Bp),
                    J=cap,
                )
                runs_oc, bl3, head_end, over = _dp_scatter_bucket(
                    bank, svc.genome_dev, strand_d, kinds_d, roffs_d,
                    rlens_d, glens_d, gstarts_d, jkp, jtp,
                    runs_oc, bl3, head_end, over,
                    L1=_DP_GRAN * (l1 + 1), L2=_DP_GRAN * (l2 + 1),
                    scoring=svc.scoring,
                )

    with _span("B.compose_dispatch"):
        (fo, fc, nrunm, res, overm, over8, strand8,
         mode8) = _compose_device(
            kinds_d, glens_d, lp_d, mode_d, curpos_d, head_end,
            runs_oc, bl3, strand_d, over, K=_RUNS_K,
        )
        fetch, big = _pack_fetch(fo, fc, nrunm, res, overm, over8,
                                 strand8, mode8, ovf_d, capped_d,
                                 lens_d)
    # start the slim result fetch asynchronously: under the 3-stage
    # chunk pipeline the host consumes this one stage later, by which
    # time the transfer has ridden out the next chunk's device work.
    # ``big`` (the full per-lane run arrays) stays device-resident —
    # fetched only if the exceptional-lane side channel overflows.
    for a in fetch:
        a.copy_to_host_async()
    redo_ctx = (mode_d, curpos_d, strand_d, lp_d, kinds_d, roffs_d,
                rlens_d, glens_d, gstarts_d)
    return (fetch, big, redo_ctx, counts_d,
            (None if exact else plan_used), out, plan_used)


def _assemble_fetch(svc, n, bctx, defer_redo=False):
    """Host half of the fused phase B: fetch the composed results,
    build the (pos, Cigar, rev) list, route overflow lanes to the host
    re-compose and escape lanes to the generator fallback.  A
    speculatively-dispatched chunk whose true bucket counts escaped
    its plan re-dispatches exactly first (jobs past a capacity were
    dropped on device, so those results must not be consumed).

    ``defer_redo=True`` (the chunk pipeline) returns a third element
    ``(redo, redo_ctx) | None`` instead of running :func:`_redo_host`
    inline: a mid-pipeline redo's device fetches queue behind the
    following chunks' automatons (~75 ms measured for ONE lane at
    1 Mb), while at end-of-call the queue is drained and all chunks'
    redos share the sync cost."""
    fetch, big, redo_ctx, counts_d, plan_used, out = bctx[:6]
    if plan_used is not None:
        counts = np.asarray(counts_d)
        planned = {b: cap for b, _c, cap in plan_used}
        bad = any(
            int(counts[b]) > planned.get(int(b), 0)
            for b in np.nonzero(counts)[0]
        )
        if bad:
            with _span("B.spec_retry"):
                return _assemble_fetch(
                    svc, n, _assemble_dispatch(svc, n, out),
                    defer_redo=defer_redo)
    if _profiling.ACTIVE is not None:
        # profiling only: a 1-element sync splits device-completion
        # wait from fetch2's transfer time
        with _span("B.devwait"):
            jax.device_get(fetch[0][:1])
    with _span("B.fetch2"):
        (res, meta, nm1, excl_idx, excl_fo, excl_fc, n_excl) = (
            np.asarray(x) for x in jax.device_get(list(fetch))
        )
        Bp = res.shape[0]
        purev = (nm1 & 0x80) != 0
        nrun8 = (nm1 & 0x7F).astype(np.int32)
        olens = svc.read_lengths()
        # reconstruct per-lane run data for renderable lanes: pure-M
        # lanes from their read length, exceptional lanes from the
        # side channel; capacity overflow -> fetch the full arrays
        fop = np.zeros((Bp,), np.uint32)
        fc32 = np.zeros((Bp, 8), np.int32)
        fop[purev] = 1  # single run, op M (op+1 == 1)
        pl = np.nonzero(purev[: olens.shape[0]])[0]
        fc32[pl, 0] = olens[pl]
        if int(n_excl[0]) > excl_idx.shape[0]:
            with _span("B.big_fallback"):
                fop_full, fc8_full = (
                    np.asarray(x) for x in jax.device_get(list(big)))
            fop, fc32 = fop_full, fc8_full.astype(np.int32)
        else:
            ev = excl_idx >= 0
            fop[excl_idx[ev]] = excl_fo[ev]
            fc32[excl_idx[ev]] = excl_fc[ev].astype(np.int32)
    # category masks in numpy, then per-category Python only where
    # objects must exist (the row-major branchy loop measured ~8 us
    # per read at 32 k lanes — most of phase B after the device fixes)
    (mode_d, curpos_d, strand_d, lp_d, kinds_d, roffs_d, rlens_d,
     glens_d, gstarts_d) = redo_ctx
    with _span("B.host_build"):
        metav = meta[:n].astype(np.int32)
        mlv = metav & 3
        strandv = (metav >> 2) & 1
        cpdv = ((metav >> 6) & 1).astype(bool)
        ovflv = ((metav >> 5) & 1).astype(bool)  # truncated log
        if _profiling.ACTIVE is not None:
            _profiling.ACTIVE.totals[
                f"B.redo_split rle={int(((metav >> 3) & 1).sum())}"
                f" m={int(((metav >> 4) & 1).sum())}"] = 0.0
        badrv = ((metav >> 3) & 0b11) != 0  # a run count overflowed a
        # device-compose width (_RLE_R block, F2 pack, _RUNS_K merge,
        # int16 count) — host-composable
        badrv |= ((metav >> 7) & 1) != 0  # > 8 runs / count > 254: the
        # compact fetch (_pack_fetch) cannot carry it — host re-compose
        rlv = res[:n].astype(np.int64)
        aligned = (mlv != 0) & ~cpdv & ~ovflv
        ok = aligned & ~badrv & (rlv != 0)
        results: list = [None] * n
        for k in np.nonzero((mlv == 0) & ~cpdv)[0].tolist():
            results[k] = (0, None, False)
        # automaton cap / truncated log -> generator; head-on-zero -> the
        # strand-retry quirk, also generator (single_align.c:271)
        fallback = np.nonzero(
            cpdv | ((mlv != 0) & ~cpdv & ovflv)
            | (aligned & ~badrv & (rlv == 0))
        )[0].tolist()
        redo = np.nonzero(aligned & badrv)[0].tolist()
        okl = np.nonzero(ok)[0].tolist()
        if okl:
            with _span("B.hb.gather"):
                oki = np.asarray(okl)
                m = len(okl)
                K = 8  # the compact fetch carries 8 runs (enough for
                # every non-redo lane by construction)
                fosel = fop[:n][oki].astype(np.uint32)
                ops_v = ((fosel[:, None] >> (2 * np.arange(K,
                         dtype=np.uint32))[None, :]) & 3).astype(
                             np.int32) - 1
                ops_b = _OPC_BYTES[ops_v]  # (m, K) uint8; invalid runs
                # index -1 (wraps) — masked off below like before
                cnts = fc32[:n][oki]
                valid = np.arange(K)[None, :] < nrun8[:n][oki, None]
            # vectorized top-first render: "<cnt><op>" per valid run,
            # columns reversed (render order = reversed(ops)), as a
            # fixed-width byte matrix — decimal digits by division,
            # leading zeros masked to 0 and dropped by the compress
            # (np.char.add chains measured 6x slower at 32 k lanes)
            with _span("B.hb.render"):
                W = 6  # up to 5 digits (pure-M counts go to read
                # length, int16-bounded) + op
                bm = np.zeros((m, K, W), np.uint8)
                rem = cnts
                started = np.zeros((m, K), bool)
                for q, p10 in enumerate((10000, 1000, 100, 10)):
                    d = rem // p10
                    rem = rem - d * p10
                    started |= d > 0
                    bm[..., q] = np.where(started, 48 + d, 0)
                bm[..., 4] = 48 + rem
                bm[..., 5] = ops_b
                bm[~valid] = 0
                flatm = bm[:, ::-1, :].reshape(m, K * W)
                mask = flatm != 0
                lens = mask.sum(1)
                flat = flatm[mask].tobytes().decode()
                offs = np.concatenate([[0], np.cumsum(lens)]).tolist()
                posl = (rlv[oki] + 1).tolist()
                revl = (strandv[oki] == 1).tolist()
            with _span("B.hb.objloop"):
                new_c = _RenderedCigar.__new__
                for j, k in enumerate(okl):
                    c = new_c(_RenderedCigar)
                    c._render = flat[offs[j]:offs[j + 1]]
                    results[k] = (posl[j], c, revl[j])
    if defer_redo:
        return results, fallback, ((redo, redo_ctx) if redo else None)
    if redo:
        # run-width overflows re-compose on the HOST path (fetch just
        # those lanes' logs, replay their DP jobs, numpy merge) — far
        # cheaper than re-aligning through the generator engine, and
        # bit-exact by the fused==host equivalence (test_fused_assemble)
        with _span(f"B.redo_n{len(redo)}"):
            results, fallback = _redo_host(
                svc, results, fallback, redo,
                mode_d, curpos_d, strand_d, lp_d, kinds_d, roffs_d,
                rlens_d, glens_d, gstarts_d)
    return results, fallback


def _redo_host(svc, results, fallback, redo, mode_d, curpos_d, strand_d,
               lp_d, kinds_d, roffs_d, rlens_d, glens_d, gstarts_d):
    """Host re-compose for fused-path lanes whose run counts overflowed
    a device-compose width (see the call site)."""
    from bwt_tpu.models.batch_exec import _pow2

    sel = np.asarray(redo, np.int32)
    J = _pow2(len(sel))
    selp = np.zeros(J, np.int32)
    selp[: len(sel)] = sel
    subs = _take_rows(
        jnp.asarray(selp),
        (mode_d, curpos_d, strand_d, lp_d, kinds_d, roffs_d,
         rlens_d, glens_d, gstarts_d),
    )
    (smode, scur, sstr, slp, skinds, sroffs, srlens, sglens,
     sgst) = (np.asarray(x) for x in jax.device_get(list(subs)))
    rsub, fsub = _assemble_logs(
        svc, len(sel), smode, scur, sstr, slp,
        np.zeros(J, bool), skinds, sroffs, srlens, sglens, sgst,
        lanes=sel,
    )
    for b, k in enumerate(redo):
        results[k] = rsub[b]
    fallback.extend(redo[b] for b in fsub)
    return results, fallback


@jax.jit
def _take_rows(sel, arrays):
    """Row-gather a tuple of device arrays (the fused path's redo-lane
    log fetch) in one dispatch."""
    return tuple(jnp.take(a, sel, axis=0) for a in arrays)


# --------------------------------------------------------------------------
# align_read (segment-chaining alternative, single_align.c:300-358)
# --------------------------------------------------------------------------


def align_read_gen(genome: np.ndarray, row: int, length: int, thresh: int):
    """Chain up to 10 MMS segments (with mms_mismatch recovery),
    accept if segments are mutually within 6 nt and cover 2/3 of the
    read.  Returns the 0-based position or 0."""
    starts = [0] * 10
    lens = [0] * 10
    nmisses = length // 10
    olen = length
    ln = length
    nsegments = 0
    while nsegments < 10:
        if ln < 10:
            break
        seglen, start, end, _pos = yield ("mms", row, 0, ln)
        if seglen < thresh:
            mlen, start, end, _skips = yield from mms_mismatch_gen(
                genome, row, ln - seglen, start, end
            )
            if mlen + seglen > 2 * thresh:
                ln -= seglen + mlen + 3
                starts[nsegments] = start
                lens[nsegments] = seglen + mlen
                nsegments += 1
                continue
            nmisses -= 1
            if nmisses + 1 == 0:
                return 0
            ln -= 3
            nsegments -= 1
            if nsegments > -1:
                starts[nsegments] -= 3
                lens[nsegments] += 3
            nsegments += 1
            continue
        if (ln - seglen == 0) or ((ln - seglen > 10) and end - start == 1):
            starts[nsegments] = start
            lens[nsegments] = seglen
            ln -= seglen + 3
            nsegments += 1
            continue
        mlen, start, end, _skips = yield from mms_mismatch_gen(
            genome, row, ln - seglen, start, end
        )
        ln -= seglen + mlen + 3
        starts[nsegments] = start
        lens[nsegments] = seglen + mlen
        nsegments += 1

    totlen = lens[0]
    if nsegments == 10:
        return 0
    for i in range(nsegments - 1):
        p1 = yield ("unc_sa", starts[i + 1])
        p0 = yield ("unc_sa", starts[i])
        if abs(p1 + lens[i + 1] - p0) < 7:
            totlen += lens[i + 1]
        else:
            return 0
    if 3 * totlen > 2 * olen:
        pos = yield ("unc_sa", starts[nsegments - 1])
        return pos - ln
    return 0


# --------------------------------------------------------------------------
# Public drivers
# --------------------------------------------------------------------------


def _read_gen(genome, glen, fwd_row, fwd_len, rev_row, rev_len, anchor_len,
              use_isa=False, spec=1, isa_spec=9):
    """One read's full single_align flow: forward, then reverse
    complement (single_align.c:483-503).  Returns (position, Cigar,
    reverse); position is the 1-based output value (0 = unaligned)."""
    s = Cigar()
    pos = yield from align_read_anchored_gen(
        genome, glen, fwd_row, fwd_len, anchor_len, s, use_isa, spec,
        isa_spec,
    )
    if pos:
        return pos + 1, s, False
    s = Cigar()
    pos = yield from align_read_anchored_gen(
        genome, glen, rev_row, rev_len, anchor_len, s, use_isa, spec,
        isa_spec,
    )
    if pos:
        return pos + 1, s, True
    return 0, None, False


def _align_chunk_dispatch(fmi, glen, codes_list, anchor_len, resolve, svc,
                          mesh=None, seed=None):
    """Phase A for one chunk: build the bank and launch the automaton.
    Returns the (still in-flight — JAX dispatch is async) device
    outputs; the caller overlaps host work with their execution.  With
    a ``mesh``, lanes shard over its 'dp' axis (``fmi`` must already
    be replicated over the mesh)."""
    n = len(codes_list)
    svc.reset_reads()
    with _span("A.bank_build"):
        _base, _rl = svc.add_reads_batch(codes_list, with_revcomp=True)
    bank = svc.bank
    Bp = bank.shape[0] // 2
    if mesh is not None:
        ndp = mesh.shape["dp"]
        if Bp % ndp:  # both powers of two -> only when Bp < dp
            bank = jnp.concatenate(
                [bank, jnp.zeros((2 * ndp - bank.shape[0], bank.shape[1]),
                                 bank.dtype)]
            )
            Bp = ndp
    lens = np.zeros(Bp, np.int32)
    lens[:n] = _rl
    live0 = np.zeros(Bp, bool)
    live0[:n] = True
    if resolve is None:
        resolve = svc._has_n
    local = Bp if mesh is None else Bp // mesh.shape["dp"]
    compact = _compact_ladder(local)
    if mesh is not None:
        return _align_automaton_mesh(
            mesh, fmi, bank, jnp.asarray(lens), jnp.asarray(live0),
            jnp.int32(glen), seed, anchor_len=anchor_len,
            resolve=resolve, compact=compact, cap_steps=_TEST_CAP,
        )
    with _span("A.launch"):
        lens_dev = jnp.asarray(lens)
        out = _align_automaton(
            fmi, bank, lens_dev, jnp.asarray(live0),
            jnp.int32(glen), None if seed is None else seed.rows,
            anchor_len=anchor_len, resolve=resolve,
            compact=compact, cap_steps=_TEST_CAP,
            seed_k=0 if seed is None else seed.k,
        )
    if _FUSED_ASSEMBLE:
        # dispatch the phase-B job bucketing NOW and start the counts
        # transfer asynchronously: under the chunk pipeline, the next
        # chunk's automaton enters the (strictly serial) device queue
        # before this chunk's phase B — a synchronous counts fetch in
        # _assemble_logs_fused would then stall the DP dispatch behind
        # it, serializing automaton and DP work that should interleave
        (mode_d, _, _, lp_d, ovf_d, kinds_d, _, rlens_d, glens_d,
         _, _) = out[:11]
        Lb = int(bank.shape[1])
        NL1, NL2 = -(-Lb // _DP_GRAN), -(-(Lb + 10) // _DP_GRAN)
        order_d, counts_d, offs_d = _job_bucket_sort(
            mode_d, lp_d, ovf_d, kinds_d, rlens_d, glens_d,
            NB=NL1 * NL2, NL2=NL2,
        )
        counts_d.copy_to_host_async()
        return tuple(out) + ((order_d, counts_d, offs_d, lens_dev),)
    return out


def _align_chunk_finish(fmi, genome, glen, codes_list, anchor_len, cfg,
                        svc, out, mesh=None):
    """Phase B for one chunk: replay the stitch logs through the DP
    service (fused on-device when possible — see
    :func:`_assemble_logs_fused`), run the host-generator fallback for
    the rare escapes (log overflow, head-on-zero strand retry).  The
    mesh path keeps the host assemble: its log arrays are sharded over
    'dp', and the fused path's job gathers would cross shards."""
    n = len(codes_list)
    if mesh is None and _FUSED_ASSEMBLE:
        results, fallback = _assemble_logs_fused(svc, n, out)
    else:
        from bwt_tpu.parallel.mesh import host_fetch

        (mode, curpos, strand, lp, ovf, kinds, roffs, rlens, glens,
         gstarts, capped) = host_fetch(tuple(out[:11]))
        results, fallback = _assemble_logs(
            svc, n, mode, curpos, strand, lp, ovf,
            kinds, roffs, rlens, glens, gstarts, capped,
        )
    return _run_fallback(fmi, genome, glen, codes_list, anchor_len, cfg,
                         svc, results, fallback)


def _run_fallback(fmi, genome, glen, codes_list, anchor_len, cfg, svc,
                  results, fallback):
    """Re-run escape lanes (log overflow, automaton cap, head-on-zero
    strand retry) on the host-generator engine — exact by
    construction."""
    if fallback:
        gens2 = [
            _read_gen(genome, glen, 2 * k, len(codes_list[k]),
                      2 * k + 1, len(codes_list[k]), anchor_len,
                      True, cfg.spec_depth, cfg.isa_spec_depth)
            for k in fallback
        ]
        for k, o in zip(fallback, BatchExecutor(svc).run(gens2)):
            results[k] = o
    return results


def _align_reads_device(fmi, genome, glen, codes_list, anchor_len, cfg, svc,
                        mesh=None):
    """Device-engine align_reads: phase A automaton (one dispatch),
    phase B log replay through the DP service, host-generator fallback
    for the rare escapes.  Read k's strands live at bank rows 2k/2k+1.

    Batches larger than ``config.search_batch`` run as a software
    pipeline over chunks: chunk i's automaton is dispatched (async)
    BEFORE chunk i-1's phase B runs, so the host-side log replay /
    CIGAR composition overlaps device execution of the next chunk.
    The chunks share one compiled signature (same Bp; ``resolve`` is
    decided globally) and each gets its own service so banks stay
    alive across the overlap.  Results are order-preserving and
    bit-identical to the unchunked path (chunking only partitions
    independent lanes).

    The cyclic GC is paused for the duration (restored on exit): the
    assembly allocates ~3 container objects per read and keeps them
    (results), so every gen0 pass promotes and the collector ends up
    running gen2 scans over the whole heap (JAX's module graph
    included) mid-chunk — measured 0.12-0.13 s of a 0.64 s 32 k-read
    chunk, with zero cycles to find (assembly builds no back-references;
    plain refcounting frees all temporaries)."""
    import gc

    was_enabled = gc.isenabled()
    gc.disable()
    try:
        return _align_reads_device_inner(
            fmi, genome, glen, codes_list, anchor_len, cfg, svc, mesh)
    finally:
        if was_enabled:
            gc.enable()


def _align_reads_device_inner(fmi, genome, glen, codes_list, anchor_len,
                              cfg, svc, mesh=None):
    chunk = cfg.search_batch
    n = len(codes_list)
    fmi_r = fmi
    if mesh is not None:
        from bwt_tpu.parallel.mesh import (
            replicate_index, shard_index, tp_view,
        )

        if mesh.shape.get("tp", 1) > 1:
            # sequence-sharded index (>HBM genomes): phase A's gathers
            # go local + psum over 'tp'; phase B (DP stitches against
            # the genome text) is unchanged
            fmi_r = tp_view(shard_index(fmi, mesh))
        else:
            fmi_r = replicate_index(fmi, mesh)
    seed = svc.seed  # built once on the master service
    if n <= chunk:
        out = _align_chunk_dispatch(
            fmi_r, glen, codes_list, anchor_len, None, svc, mesh, seed)
        return _align_chunk_finish(
            fmi, genome, glen, codes_list, anchor_len, cfg, svc, out,
            mesh)
    if isinstance(codes_list, np.ndarray):
        resolve = bool((codes_list == 5).any())
    else:
        resolve = any((np.asarray(r) == 5).any() for r in codes_list)
    results: list = []
    if mesh is None and _FUSED_ASSEMBLE:
        # 3-stage pipeline: dispatch chunk k's automaton, then chunk
        # k-1's phase-B device half (DP + compose + async fetch), then
        # the HOST half of chunk k-2 — whose fetched bytes arrived
        # while the device crunched chunk k-1.  The device queue never
        # drains behind host-side Cigar building, and the host never
        # blocks on a transfer that hasn't ridden out a full stage.
        pend: list = []  # [svc_i, sub, bctx]
        # bucket plan from the latest finished chunk (seeded from the
        # cross-call memo) for speculative phase-B dispatch — without a
        # seed, chunks dispatched before the first fetch_stage would
        # each BLOCK ~150 ms on their exact counts sync
        memo_key = None
        state = {"plan": None}

        done: list = []  # per-chunk (svc, sub, results, fallback, redo)

        def fetch_stage(e):
            res_i, fb, rp = _assemble_fetch(
                e[0], len(e[1]), e[2], defer_redo=True)
            cd = np.asarray(e[2][3])  # true counts (ready: results are)
            state["plan"] = _PLAN_MEMO[memo_key] = _merge_plan(
                state["plan"],
                [(int(b), int(cd[b]), _cap_for(int(cd[b])))
                 for b in np.nonzero(cd)[0]],
            )
            # hold the chunk's service (its 20 MB device bank) only if
            # the drain still needs it — a 1 M-read run would otherwise
            # pin ~32 banks until the end
            done.append((e[0] if (fb or rp) else None,
                         e[1], res_i, fb, rp))

        for lo in range(0, n, chunk):
            sub = codes_list[lo : lo + chunk]
            svc_i = QueryService(fmi, svc.genome_dev, cfg) \
                if svc.genome_dev is not None \
                else QueryService(fmi, genome, cfg)
            # per-iteration order over the device's in-order stream: (1)
            # HOST-build chunk k-2's results first — its bytes arrived
            # during earlier device work, and the build overlaps
            # automaton k-1 still executing; (2) phase-B dispatch of k-1
            # — its bucket-counts fetch now stalls ~host_build less, and
            # it must precede the next automaton in the queue or the
            # wait serializes behind it; (3) bank-build + dispatch
            # automaton k
            if len(pend) >= 3:
                fetch_stage(pend.pop(0))
            if pend:
                if memo_key is None:
                    memo_key = (int(pend[-1][2][3].shape[0]),
                                int(pend[-1][0].bank.shape[1]))
                    if state["plan"] is None:
                        state["plan"] = _PLAN_MEMO.get(memo_key)
                # speculative when equally-sized chunks make the
                # previous chunk's (or the memo's) bucket plan a
                # reliable guess
                use_plan = state["plan"] if (
                    state["plan"] is not None
                    and len(pend[-1][1]) == chunk
                ) else None
                pend[-1][2] = _assemble_dispatch(
                    pend[-1][0], len(pend[-1][1]), pend[-1][2],
                    plan=use_plan)
                if use_plan is None:
                    # the exact dispatch just paid the counts sync —
                    # its plan seeds the NEXT chunk's speculative
                    # dispatch (previously the second chunk blocked
                    # exactly too, because no fetch_stage had run yet)
                    state["plan"] = _merge_plan(
                        state["plan"], pend[-1][2][6])
            out = _align_chunk_dispatch(
                fmi_r, glen, sub, anchor_len, resolve, svc_i, None,
                seed)
            pend.append([svc_i, sub, out])
        pend[-1][2] = _assemble_dispatch(
            pend[-1][0], len(pend[-1][1]), pend[-1][2],
            plan=state["plan"] if (
                state["plan"] is not None
                and len(pend[-1][1]) == chunk
            ) else None)
        for e in pend:
            fetch_stage(e)
        # drain: deferred redos (all chunks' syncs share one idle-queue
        # pass) then the generator fallbacks, in chunk order
        for svc_i, sub, res_i, fb, rp in done:
            if svc_i is None:  # nothing deferred for this chunk
                results.extend(res_i)
                continue
            if rp is not None:
                with _span(f"B.redo_n{len(rp[0])}"):
                    res_i, fb = _redo_host(svc_i, res_i, fb, rp[0],
                                           *rp[1])
            results.extend(_run_fallback(
                fmi, genome, glen, sub, anchor_len, cfg, svc_i, res_i,
                fb))
        return results
    prev = None
    for lo in range(0, n, chunk):
        sub = codes_list[lo : lo + chunk]
        svc_i = QueryService(fmi, svc.genome_dev, cfg) \
            if svc.genome_dev is not None else QueryService(fmi, genome, cfg)
        out = _align_chunk_dispatch(
            fmi_r, glen, sub, anchor_len, resolve, svc_i, mesh, seed)
        if prev is not None:
            results.extend(_align_chunk_finish(
                fmi, genome, glen, prev[1], anchor_len, cfg, prev[0],
                prev[2], mesh))
        prev = (svc_i, sub, out)
    results.extend(_align_chunk_finish(
        fmi, genome, glen, prev[1], anchor_len, cfg, prev[0], prev[2],
        mesh))
    return results


def align_reads(
    fmi: FMIndex,
    genome,
    reads,
    *,
    anchor_len: int | None = None,
    config=None,
    service: QueryService | None = None,
    with_strand: bool = False,
    engine: str = "auto",
    mesh=None,
):
    """Align a batch of reads (ASCII strings or code arrays).

    Returns a list of (position, Cigar | None): 1-based genome
    position of the alignment start (0 = unaligned) and its CIGAR —
    or (position, Cigar, reverse) triples when ``with_strand`` is set
    (for SAM emission, utils/sam.py).  Pass a reusable ``service`` to
    amortize the genome upload across calls.

    ``engine``: "device" runs the FM control flow as one jitted
    while_loop (:func:`_align_automaton`) with the stitch log replayed
    through the DP service; "host" runs the generator executor (one
    fused dispatch per scheduler round); "auto" (default) picks the
    device automaton whenever ``fmi.isa_samples`` is present — outputs
    are identical either way (the stdout-parity suite pins both).

    Throughput tip: the aligner's locate walks dominate device time;
    an index built with ``sa_sample_rate=8`` (identical outputs,
    +0.375 B/base memory) shortens every walk 4x.

    ``mesh``: a `jax.sharding.Mesh` with a 'dp' axis scales the device
    automaton data-parallel — lanes shard across chips, the index
    replicates, each shard runs collective-free and exits early
    (:func:`_align_automaton_mesh`).  Device-engine only; outputs are
    bit-identical to the single-device run.
    """
    from bwt_tpu.config import DEFAULT

    # config resolution: an explicit config wins everywhere (a reused
    # service whose captured config disagrees is re-wrapped so DP
    # scoring can't silently diverge between the service's stitches
    # and this call — and between the chunked / unchunked paths, which
    # build per-chunk services from the call's config); with no
    # explicit config, a provided service's own config governs.
    if config is not None:
        cfg = config
    elif service is not None:
        cfg = service.config
    else:
        cfg = DEFAULT
    if anchor_len is None:
        anchor_len = cfg.anchor_len
    if engine not in ("auto", "device", "host"):
        raise ValueError(f"unknown engine {engine!r}")
    genome = _as_genome_codes(genome)
    glen = len(genome)
    if service is not None and service.config is not cfg:
        service = QueryService(
            fmi,
            service.genome_dev if service.genome_dev is not None else genome,
            cfg,
        )
    svc = service if service is not None else QueryService(fmi, genome, cfg)
    if isinstance(reads, np.ndarray) and reads.ndim == 2:
        # uniform-length code-matrix fast path: per-read Python loops
        # (encode/validate/N-scan) cost ~10 us/read — 1.3 s at 131 k
        # reads, comparable to the whole device pipeline
        codes_list = np.ascontiguousarray(reads).astype(
            np.uint8, copy=False)
        if codes_list.shape[1] > cfg.max_read_len:
            raise ValueError(
                f"read length {codes_list.shape[1]} exceeds "
                f"config.max_read_len {cfg.max_read_len} "
                "(single_align.c:369's buffer bound)"
            )
        max_len = codes_list.shape[1] if codes_list.shape[0] else 0
    else:
        codes_list = []
        for r in reads:
            fwd = codec.encode_read(r) if isinstance(r, (str, bytes)) \
                else np.asarray(r, np.uint8)
            if len(fwd) > cfg.max_read_len:
                raise ValueError(
                    f"read length {len(fwd)} exceeds config.max_read_len "
                    f"{cfg.max_read_len} (single_align.c:369's buffer bound)"
                )
            codes_list.append(fwd)
        max_len = max((len(c) for c in codes_list), default=0)
    use_dev = engine == "device" or (
        engine == "auto" and fmi.isa_samples is not None
    )
    # the automaton's stitch log stores read offsets/lengths as int16
    # (_align_automaton state); reads past that width must run on the
    # host generator (bit-exact either way; config.max_read_len's
    # 65536 bound still applies to both engines)
    if use_dev and max_len > 32767:
        if engine == "device" or mesh is not None:
            raise ValueError(
                f"read length {max_len} exceeds the device automaton's "
                "int16 stitch-log width (32767); use engine='host'"
            )
        use_dev = False
    if mesh is not None and not use_dev:
        raise ValueError("mesh= requires the device engine "
                         "(an index with isa_samples)")
    if use_dev:
        results = _align_reads_device(
            fmi, genome, glen, codes_list, anchor_len, cfg, svc, mesh)
    else:
        results = _align_reads_host(fmi, genome, glen, codes_list,
                                    anchor_len, cfg, svc)
    if with_strand:
        return results
    return [(p, c) for p, c, _ in results]


def _align_reads_host(fmi, genome, glen, codes_list, anchor_len, cfg,
                      svc):
    """The host-generator engine run (the device automaton's bit-exact
    fallback/reference engine)."""
    svc.reset_reads()
    gens = []
    for fwd in codes_list:
        rev = codec.revcomp(fwd)
        fr = svc.add_read(fwd)
        rr = svc.add_read(rev)
        gens.append(
            _read_gen(genome, glen, fr, len(fwd), rr, len(rev),
                      anchor_len, fmi.isa_samples is not None,
                      cfg.spec_depth, cfg.isa_spec_depth)
        )
    return BatchExecutor(svc).run(gens)


def align_read_anchored(
    fmi: FMIndex, genome, read, *, anchor_len: int = DEFAULT_ANCHOR_LEN
):
    """Single-read anchored alignment (no reverse-complement retry).
    Returns (position_0based, Cigar)."""
    genome = _as_genome_codes(genome)
    pattern = (
        codec.encode_read(read) if isinstance(read, (str, bytes)) else np.asarray(read, np.uint8)
    )
    svc = QueryService(fmi, genome)
    row = svc.add_read(pattern)
    s = Cigar()

    def gen():
        pos = yield from align_read_anchored_gen(
            genome, len(genome), row, len(pattern), anchor_len, s,
            fmi.isa_samples is not None,
        )
        return pos

    (pos,) = BatchExecutor(svc).run([gen()])
    return pos, s


def align_read(fmi: FMIndex, genome, read, *, thresh: int | None = None, config=None):
    """Single-read segment-chaining alignment (align_read, single_align.c:300).
    ``thresh`` defaults to config.chain_thresh (the reference's 10,
    single_align.c:482)."""
    from bwt_tpu.config import DEFAULT

    if thresh is None:
        thresh = (config or DEFAULT).chain_thresh
    genome = _as_genome_codes(genome)
    pattern = (
        codec.encode_read(read) if isinstance(read, (str, bytes)) else np.asarray(read, np.uint8)
    )
    svc = QueryService(fmi, genome)
    row = svc.add_read(pattern)
    (pos,) = BatchExecutor(svc).run(
        [align_read_gen(genome, row, len(pattern), thresh)]
    )
    return pos


def _as_genome_codes(genome) -> np.ndarray:
    if isinstance(genome, (str, bytes)):
        return codec.encode_genome(genome)
    return np.asarray(genome, np.uint8)


def format_ref_output(results) -> str:
    """Render align_reads results exactly like the single_align main
    loop (single_align.c:484-503): '<pos>\\n <CIGAR>\\n' per aligned
    read, '0\\n' per unaligned."""
    out = []
    for pos, cig in results:
        if pos:
            out.append(f"{pos}\n")
            out.append(cig.render_ref_line())
        else:
            out.append("0\n")
    return "".join(out)
