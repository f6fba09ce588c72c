"""The config layer must actually be consumed: a change to any field
alters behavior, and defaults reproduce the reference bit-exactly
(the parity suite covers the latter; here we pin the former)."""

import dataclasses

import numpy as np
import pytest

import bwt_tpu
from bwt_tpu.config import Config, DEFAULT
from bwt_tpu.ops import align as align_ops
from bwt_tpu.utils.cigar import Cigar

from host_ref import random_codes


def test_default_scoring_matches_reference_constants():
    assert DEFAULT.dp_scoring == (0, -6, -5, -3)  # smw.c:41-54


def test_scoring_change_alters_dp_output():
    read = [0, 1, 2, 3, 0, 1, 2]
    genome = [0, 1, 1, 3, 0, 0, 1, 2]
    c1 = Cigar()
    e1 = align_ops.nw_fast(read, genome, c1)
    # make gaps free and mismatches fatal: alignment must change
    c2 = Cigar()
    e2 = align_ops.nw_fast(read, genome, c2, scoring=(0, -100, 0, 0))
    assert (e1, c1.render()) != (e2, c2.render())
    # batch path consumes the same scoring source
    v1, _ = align_ops.dp_fill_batch(
        np.asarray([read], np.int32), np.asarray([genome], np.int32)
    )
    v2, _ = align_ops.dp_fill_batch(
        np.asarray([read], np.int32), np.asarray([genome], np.int32),
        (0, -100, 0, 0),
    )
    assert not np.array_equal(np.asarray(v1), np.asarray(v2))
    hv1, _ = align_ops.dp_fill(read, genome)
    assert np.array_equal(np.asarray(v1[0]), hv1)
    hv2, _ = align_ops.dp_fill(read, genome, (0, -100, 0, 0))
    assert np.array_equal(np.asarray(v2[0]), hv2)


def test_scoring_reaches_pallas_kernel():
    """The device diagonal fill (the executor's and phase B's DP)
    consumes the scoring it is given."""
    reads = np.asarray([[0, 1, 2, 3]], np.int32)
    genomes = np.asarray([[0, 1, 1, 3, 0]], np.int32)
    v1, _ = align_ops.dp_fill_diagonals(reads, genomes)
    v2, _ = align_ops.dp_fill_diagonals(reads, genomes, (1, -2, -9, -1))
    assert not np.array_equal(np.asarray(v1), np.asarray(v2))
    hv2, _ = align_ops.dp_fill(reads[0], genomes[0], (1, -2, -9, -1))
    # per-diagonal layout [d, i, b] == conventional [i, d-i]
    i = np.arange(5)[:, None]
    j = np.arange(6)[None, :]
    assert np.array_equal(np.asarray(v2)[i + j, i, 0], hv2)


def test_sa_rate_flows_from_config(rng):
    codes = random_codes(rng, 600)
    fmi = bwt_tpu.build_index(codes, config=Config(sa_sample_rate=8))
    assert fmi.sa_rate == 8
    assert len(np.asarray(fmi.sa_samples)) == 1 + 600 // 8
    # explicit argument wins over config
    fmi2 = bwt_tpu.build_index(
        codes, sa_sample_rate=16, config=Config(sa_sample_rate=8)
    )
    assert fmi2.sa_rate == 16


def test_rank_blocksize_is_validated(rng):
    codes = random_codes(rng, 100)
    with pytest.raises(ValueError, match="rank_blocksize"):
        bwt_tpu.build_index(codes, config=Config(rank_blocksize=8))


def test_search_batch_chunking_is_equivalent(rng):
    from bwt_tpu.models import exact

    codes = random_codes(rng, 3000)
    fmi = bwt_tpu.build_index(codes)
    reads = []
    for _ in range(11):
        j = int(rng.integers(0, 3000 - 40))
        reads.append("".join("ACGT"[c] for c in codes[j : j + 40]))
    full = exact.search_reads(fmi, reads)
    chunked = exact.search_reads(
        fmi, reads, config=Config(search_batch=4)
    )
    for k in full:
        assert np.array_equal(full[k], chunked[k]), k


def test_max_read_len_enforced(rng):
    from bwt_tpu.models import aligner, exact

    codes = random_codes(rng, 500)
    fmi = bwt_tpu.build_index(codes)
    long_read = "A" * 40
    cfg = Config(max_read_len=30)
    with pytest.raises(ValueError, match="max_read_len"):
        aligner.align_reads(fmi, codes, [long_read], config=cfg)
    with pytest.raises(ValueError, match="max_read_len"):
        exact.search_reads(fmi, [long_read], config=cfg)


def test_chain_thresh_default_from_config(rng):
    from bwt_tpu.models import aligner

    codes = random_codes(rng, 2000)
    fmi = bwt_tpu.build_index(codes)
    j = int(rng.integers(0, 2000 - 60))
    read = codes[j : j + 60]
    assert aligner.align_read(fmi, codes, read) == aligner.align_read(
        fmi, codes, read, thresh=DEFAULT.chain_thresh
    )


def test_scoring_flows_through_aligner_service(rng):
    """A config scoring change must reach the executor's DP stitches."""
    from bwt_tpu.models import aligner

    codes = random_codes(rng, 4000)
    fmi = bwt_tpu.build_index(codes)
    reads = []
    for _ in range(6):
        j = int(rng.integers(0, 4000 - 70))
        r = list(codes[j : j + 70])
        # a small indel so a gap stitch actually runs
        del r[30:33]
        r[10] ^= 3
        reads.append(np.asarray(r, np.uint8))
    base = aligner.align_reads(fmi, codes, reads)
    weird = aligner.align_reads(
        fmi, codes, reads,
        config=dataclasses.replace(
            DEFAULT, mismatch=-100, gap_open=0, gap_extend=0
        ),
    )
    base_r = [(p, c.render() if c else None) for p, c in base]
    weird_r = [(p, c.render() if c else None) for p, c in weird]
    assert base_r != weird_r


def test_config_overrides_reused_service_scoring(rng):
    """An explicit config= must win over a reused service's captured
    config — the service is re-wrapped so DP stitches can't silently
    run with stale scoring (and the chunked / unchunked paths agree)."""
    from bwt_tpu.models import aligner
    from bwt_tpu.models.batch_exec import QueryService

    codes = random_codes(rng, 4000)
    fmi = bwt_tpu.build_index(codes)
    reads = []
    for _ in range(6):
        j = int(rng.integers(0, 4000 - 70))
        r = list(codes[j : j + 70])
        del r[30:33]
        r[10] ^= 3
        reads.append(np.asarray(r, np.uint8))
    weird_cfg = dataclasses.replace(
        DEFAULT, mismatch=-100, gap_open=0, gap_extend=0
    )
    want = aligner.align_reads(fmi, codes, reads, config=weird_cfg)
    # stale service built with DEFAULT scoring: config= must override
    svc = QueryService(fmi, codes)
    got = aligner.align_reads(fmi, codes, reads, config=weird_cfg,
                              service=svc)
    assert [(p, c.render() if c else None) for p, c in want] == \
        [(p, c.render() if c else None) for p, c in got]
    # and with no config=, the service's own config governs
    svc_w = QueryService(fmi, codes, weird_cfg)
    got2 = aligner.align_reads(fmi, codes, reads, service=svc_w)
    assert [(p, c.render() if c else None) for p, c in want] == \
        [(p, c.render() if c else None) for p, c in got2]
