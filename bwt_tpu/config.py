"""Configuration layer.

The reference hardcodes every tunable as a magic constant (SURVEY.md
section 5): rank checkpoint blocksize 16 (seqindex.c:182), SA sample
rate 32 (seqindex.c:173-176), anchor lengths 12 / 20
(single_align.c:483, search_reads.c:115), NW/SW scoring -5/-3/-6
(smw.c:41-54), MMS cutoffs 14/10 (rnaseqtest.c:197,219), pair window
10 kb (search_reads.c:154), pthread-spawn threshold 10 M
(histsortcomp.c:170), 64 KiB max read buffer (single_align.c:369).
This dataclass exposes them all; defaults reproduce the reference
bit-exactly, and the parity-sensitive ones are marked — changing those
departs from reference-equivalent output.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Config:
    # --- index layout (parity-sensitive: serialized format + rank math)
    sa_sample_rate: int = 32       # seqindex.c:173-176; build_index default
    rank_blocksize: int = 16       # seqindex.c:182 (== bases per uint32 word);
    # structural: the packed-word layout fixes this at 16 — build_index
    # validates and rejects any other value

    # --- alignment drivers
    anchor_len: int = 12           # single_align.c:483
    min_anchor: int = 20           # search_reads.c:115,119
    pair_window: int = 10_000      # search_reads.c:154
    chain_thresh: int = 10         # single_align.c:482 (align_read)
    max_read_len: int = 65_536     # single_align.c:369 (256*256 buffer)

    # --- DP scoring (parity-sensitive vs smw.c:41-54)
    match: int = 0
    mismatch: int = -6
    gap_open: int = -5
    gap_extend: int = -3

    # --- spliced alignment (rnaseqtest.c)
    rnaseq_anchor_cutoff: int = 14  # rnaseqtest.c:197
    rnaseq_cont_cutoff: int = 10    # rnaseqtest.c:219

    # --- execution
    search_batch: int = 1 << 15     # reads per lockstep device step
    automaton_seed_k: int = 12      # seed-table depth for the device
    # automatons' mms/bsearch rounds: each round's first k backward
    # -search steps resolve from one (4^k, 6)-row table gather instead
    # of k x 2 rank gathers (bit-exact — the table stores the full
    # search state incl. emptied-early, ops/search.SeedTable).  0
    # disables.  The table is built lazily once per QueryService (k is
    # clamped to 6 for an index on the CPU backend, where a 4^12-row
    # build costs more than it saves).
    gen_seq_default_len: int = 100_000  # gen_seq.c:17
    # The three speculation depths below were tuned before the GPU
    # port and are not yet measured on the H100 (ROADMAP queue 1).
    spec_depth: int = 1             # speculative retry-chain batching
    # (batch_exec "par" protocol) for the aligner's anchor hunt: how
    # many deterministic ln-3 retries issue per round.  Outputs are
    # identical at any value >= 1; higher trades wasted device lanes
    # for fewer host<->device round trips.  The anchor usually hits on
    # the first try, so speculation mostly burns lanes (the curgap-loop
    # fusion is separate and always on).  No reference analog (the C
    # drivers are sequential).
    rnaseq_spec_depth: int = 24     # same knob for rna_seq's len-1
    # retry chains (anchor hunt + gap re-anchor), whose chains run up
    # to ~35 sequential rounds; unlike the aligner's curgap lanes,
    # each speculative retry here shortens the pattern by 1, so deep
    # chunks cost little extra device work.
    isa_spec_depth: int = 1         # speculative chunk size for the
    # aligner's backward-extension curgap loop on the inverse-SA path
    # (single_align.c:224-247's curgap=1..9): each chunk of gap
    # hypotheses issues as one "par" round; replies are consumed in
    # the sequential loop's order, so outputs are identical at any
    # value in [1, 9].  Each speculative lane runs a near-full-length
    # LF loop, and on substitution-dominated reads curgap=1 is
    # accepted almost always, so deeper chunks mostly burn device
    # lanes.  Indel-heavy read sets may prefer 2-3.

    @property
    def dp_scoring(self) -> tuple[int, int, int, int]:
        """(match, mismatch, gap_open, gap_extend) — the single source
        of truth consumed by every DP fill (ops.align.dp_fill,
        dp_fill_diagonals and the executor's DP service)."""
        return (self.match, self.mismatch, self.gap_open, self.gap_extend)


DEFAULT = Config()
