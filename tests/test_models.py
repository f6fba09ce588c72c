"""End-to-end parity of the alignment model drivers vs the reference
binaries (single_align, align_read, rna_seq) and property tests for
the search_reads pipeline."""

import pathlib
import subprocess

import numpy as np
import pytest

import bwt_tpu
from bwt_tpu import codec
from bwt_tpu import io as bio
from bwt_tpu.models import aligner, exact, rnaseq

from oracle import oracle

GLEN = 20000
ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def genome_env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("aln")
    g = codec.random_genome(GLEN, seed=99)
    seqfile = tmp / "genome.txt"
    seqfile.write_text(g)
    fmi = bwt_tpu.build_index(g)
    idxfile = tmp / "genome.idx"
    bio.write_ref_index(fmi, idxfile)
    return g, fmi, seqfile, idxfile, tmp


def _mutate(rng, read, n_edits, alphabet=4):
    read = list(read)
    for _ in range(n_edits):
        if not read:
            break
        k = int(rng.integers(0, len(read)))
        op = rng.random()
        if op < 0.5:
            read[k] = "ACGT"[int(rng.integers(0, alphabet))]
        elif op < 0.75:
            read.insert(k, "ACGT"[int(rng.integers(0, alphabet))])
        else:
            del read[k]
    return "".join(read)


def make_reads(rng, g, n, minlen=40, maxlen=90, revcomp_frac=0.3, junk_frac=0.1):
    reads = []
    comp = str.maketrans("ACGT", "TGCA")
    for _ in range(n):
        if rng.random() < junk_frac:
            reads.append(
                "".join("ACGT"[int(c)] for c in rng.integers(0, 4, size=50))
            )
            continue
        rl = int(rng.integers(minlen, maxlen))
        j = int(rng.integers(0, len(g) - rl))
        r = _mutate(rng, g[j : j + rl], int(rng.integers(0, 4)))
        if rng.random() < revcomp_frac:
            r = r.translate(comp)[::-1]
        if rng.random() < 0.1 and r:
            r = list(r)
            r[int(rng.integers(0, len(r)))] = "N"
            r = "".join(r)
        reads.append(r)
    return [r for r in reads if r]


def test_single_align_stdout_parity(genome_env, rng):
    g, fmi, seqfile, idxfile, tmp = genome_env
    reads = make_reads(rng, g, 80)
    readfile = tmp / "reads.txt"
    readfile.write_text("\n".join(reads) + "\n")
    res = subprocess.run(
        [str(oracle("single_align")), str(seqfile), str(idxfile), str(readfile)],
        capture_output=True, check=True,
    )
    want = res.stdout.decode()
    got = aligner.format_ref_output(aligner.align_reads(fmi, g, reads))
    assert got == want


def test_align_read_parity(genome_env, rng):
    g, fmi, seqfile, _, tmp = genome_env
    # align_read (segment chaining) wants mostly-clean reads
    reads = make_reads(rng, g, 40, revcomp_frac=0.0, junk_frac=0.05)
    reads = [r.replace("N", "A") for r in reads]
    readfile = tmp / "reads_chain.txt"
    readfile.write_text("\n".join(reads) + "\n")
    res = subprocess.run(
        [str(oracle("align_main")), str(seqfile), str(readfile)],
        capture_output=True, check=True,
    )
    want = [int(x) for x in res.stdout.split()]
    got = [aligner.align_read(fmi, g, r) for r in reads]
    assert got == want


def test_rna_seq_parity(genome_env, rng):
    g, fmi, seqfile, _, tmp = genome_env
    reads = []
    for _ in range(50):
        j = int(rng.integers(0, len(g) - 50))
        r = list(g[j : j + 50])
        k = 20 + int(rng.integers(0, 10))
        r[k] = "ACGT"[("ACGT".index(r[k])) ^ 3]  # rnaseqtest.c:321-322
        reads.append("".join(r))
    readfile = tmp / "reads_rna.txt"
    readfile.write_text("\n".join(reads) + "\n")
    res = subprocess.run(
        [str(oracle("rnaseq_main")), str(seqfile), str(readfile)],
        capture_output=True, check=True,
    )
    want = [
        int(t) for t in res.stdout.decode().replace("Should be right?", " ").split()
    ]
    got = list(rnaseq.rna_seq(fmi, reads))
    assert got == want


def test_align_reads_device_matches_host(genome_env, rng):
    """The device-resident aligner automaton + stitch-log replay
    (models/aligner._align_automaton) must reproduce the generator
    executor exactly: positions, CIGARs, and strands — including
    anchor-hunt exhaustion, re-anchors (log reset), junk reads, tiny
    reads, and N-containing reads."""
    g, fmi, _, _, _ = genome_env
    assert fmi.isa_samples is not None
    reads = make_reads(rng, g, 120)
    for ln in (1, 4, 5, 11, 12, 13, 15):
        j = int(rng.integers(0, len(g) - ln))
        reads.append(g[j : j + ln])
    host = aligner.align_reads(fmi, g, reads, engine="host",
                               with_strand=True)
    dev = aligner.align_reads(fmi, g, reads, engine="device",
                              with_strand=True)
    for k, (h, d) in enumerate(zip(host, dev)):
        assert h[0] == d[0] and h[2] == d[2], (k, h, d)
        assert str(h[1]) == str(d[1]) if h[1] else d[1] is None, (k, h, d)


def test_align_device_compaction_matches_host(genome_env, rng, monkeypatch):
    """The automaton's two-stage live-lane compaction (compact > 0:
    stage-1 loop exits when few lanes are live, argsort+gather packs
    the stragglers, stage 2 finishes, results scatter back) must be
    bit-identical to the host engine.  Forced here on a small batch by
    lowering the lane threshold."""
    g, fmi, _, _, _ = genome_env
    assert fmi.isa_samples is not None
    monkeypatch.setattr(aligner, "_COMPACT_AT", 64)
    reads = make_reads(rng, g, 150)
    host = aligner.align_reads(fmi, g, reads, engine="host",
                               with_strand=True)
    dev = aligner.align_reads(fmi, g, reads, engine="device",
                              with_strand=True)
    for k, (h, d) in enumerate(zip(host, dev)):
        assert h[0] == d[0] and h[2] == d[2], (k, h, d)
        assert str(h[1]) == str(d[1]) if h[1] else d[1] is None, (k, h, d)


def test_align_device_spec_anchor_matches_plain(genome_env, rng):
    """The speculative anchor-retry chain (_service_core spec_anch:
    up to S ln-3 retries batched in one service op, off by default
    after measuring a loss vs compaction) must stay bit-identical to
    the plain automaton — same phase-machine inputs by construction."""
    import functools

    g, fmi, _, _, _ = genome_env
    assert fmi.isa_samples is not None
    reads = make_reads(rng, g, 120)
    plain = aligner.align_reads(fmi, g, reads, engine="device",
                                with_strand=True)
    orig = aligner._align_automaton

    def forced(*a, **kw):
        kw["spec_anch"] = 3
        return orig(*a, **kw)

    try:
        aligner._align_automaton = forced
        spec = aligner.align_reads(fmi, g, reads, engine="device",
                                   with_strand=True)
    finally:
        aligner._align_automaton = orig
    for k, (h, d) in enumerate(zip(plain, spec)):
        assert h[0] == d[0] and h[2] == d[2], (k, h, d)
        assert str(h[1]) == str(d[1]) if h[1] else d[1] is None, (k, h, d)


def test_align_device_pipeline_matches_host(genome_env, rng):
    """Batches larger than config.search_batch run chunk-pipelined
    (chunk i's automaton dispatched before chunk i-1's phase B);
    results must be order-preserving and bit-identical to the host
    engine.  Forced here with a tiny search_batch (3 chunks + tail)."""
    import dataclasses

    from bwt_tpu.config import DEFAULT

    g, fmi, _, _, _ = genome_env
    assert fmi.isa_samples is not None
    cfg = dataclasses.replace(DEFAULT, search_batch=48)
    reads = make_reads(rng, g, 150)
    host = aligner.align_reads(fmi, g, reads, engine="host",
                               with_strand=True)
    dev = aligner.align_reads(fmi, g, reads, engine="device",
                              with_strand=True, config=cfg)
    for k, (h, d) in enumerate(zip(host, dev)):
        assert h[0] == d[0] and h[2] == d[2], (k, h, d)
        assert str(h[1]) == str(d[1]) if h[1] else d[1] is None, (k, h, d)


def test_align_device_overflow_fallback(genome_env):
    """Reads with a clean anchor tail and dense mutations chain enough
    ext stitches to overflow the 16-slot device log; the automaton must
    flag those lanes and the driver must fall back to the host
    generator — outputs identical either way.  Also covers reads
    anchored at genome position 0 (head-on-zero quirk territory).

    Uses a local fixed-seed rng (the shared session rng's state depends
    on test order, and the ovf>0 assertion needs this exact workload)."""
    import jax.numpy as jnp

    g, fmi, _, _, _ = genome_env
    rng = np.random.default_rng(777)
    reads = []
    for step in (6, 7, 8):
        for _ in range(8):
            s = int(rng.integers(0, len(g) - 130))
            r = list(g[s : s + 120])
            for p in range(2, 100, step):  # clean tail [100:120) anchors
                r[p] = "ACGT"["ACGT".index(r[p]) ^ int(rng.integers(1, 4))]
            reads.append("".join(r))
    for L, p in ((40, 20), (50, 25), (60, 30), (70, 35)):
        r = list(g[:L])
        r[p] = "ACGT"["ACGT".index(r[p]) ^ 3]
        reads.append("".join(r))

    # the automaton must actually hit the overflow path on this workload
    from bwt_tpu.models.batch_exec import QueryService

    codes_list = [codec.encode_read(r) for r in reads]
    svc = QueryService(fmi, codec.encode_genome(g))
    svc.add_reads_batch(codes_list, with_revcomp=True)
    Bp = svc.bank.shape[0] // 2
    lens = np.zeros(Bp, np.int32)
    lens[: len(codes_list)] = [len(r) for r in codes_list]
    live0 = np.zeros(Bp, bool)
    live0[: len(codes_list)] = True
    out = aligner._align_automaton(
        fmi, svc.bank, jnp.asarray(lens), jnp.asarray(live0),
        jnp.int32(len(g)), anchor_len=12, resolve=False,
    )
    assert int(np.asarray(out[4])[: len(codes_list)].sum()) > 0

    host = aligner.align_reads(fmi, g, reads, engine="host",
                               with_strand=True)
    dev = aligner.align_reads(fmi, g, reads, engine="device",
                              with_strand=True)
    for k, (h, d) in enumerate(zip(host, dev)):
        assert h[0] == d[0] and h[2] == d[2], (k, h, d)
        assert str(h[1]) == str(d[1]) if h[1] else d[1] is None, (k, h, d)


def test_rna_seq_device_matches_host(genome_env, rng):
    """The device-resident automaton (one jitted while_loop,
    models/rnaseq._rna_seq_automaton) must reproduce the generator
    executor exactly — including anchor hunts that exhaust (random
    reads), gap re-anchors, short reads, and the continue-collapse
    path (length < cont_cutoff after the -3 step)."""
    g, fmi, _, _, _ = genome_env
    assert fmi.isa_samples is not None
    reads = []
    for _ in range(120):
        j = int(rng.integers(0, len(g) - 55))
        r = list(g[j : j + 50])
        for _ in range(int(rng.integers(0, 5))):
            k = int(rng.integers(0, len(r)))
            r[k] = "ACGT"[int(rng.integers(0, 4))]
        reads.append("".join(r))
    # hunt-exhausting junk + boundary lengths around the 14/18 cutoffs
    for _ in range(30):
        reads.append(
            "".join("ACGT"[int(c)] for c in rng.integers(0, 4, size=50))
        )
    for ln in (1, 5, 13, 14, 15, 18, 19, 21, 22, 25):
        j = int(rng.integers(0, len(g) - ln))
        reads.append(g[j : j + ln])
    host = rnaseq.rna_seq(fmi, reads, engine="host")
    dev = rnaseq.rna_seq(fmi, reads, engine="device")
    np.testing.assert_array_equal(host, dev)


def test_automaton_cap_routes_to_fallback(genome_env, rng, monkeypatch):
    """A lane still live when the automaton hits its iteration cap must
    be routed to the host-generator fallback, never reported from its
    mid-flight state (VERDICT r2: the old behavior read as 'unaligned').
    Forced via the _TEST_CAP hook: with a tiny cap most lanes escape,
    and outputs must STILL match the uncapped run exactly — for both
    the aligner and the rnaseq driver."""
    import jax.numpy as jnp

    g, fmi, _, _, _ = genome_env
    reads = make_reads(rng, g, 24)

    want = aligner.align_reads(fmi, g, reads, engine="device",
                               with_strand=True)

    monkeypatch.setattr(aligner, "_TEST_CAP", 6)
    # the tiny cap actually trips: capped lanes exist on this workload
    from bwt_tpu.models.batch_exec import QueryService

    codes_list = [codec.encode_read(r) for r in reads]
    svc = QueryService(fmi, codec.encode_genome(g))
    svc.add_reads_batch(codes_list, with_revcomp=True)
    Bp = svc.bank.shape[0] // 2
    lens = np.zeros(Bp, np.int32)
    lens[: len(codes_list)] = [len(r) for r in codes_list]
    live0 = np.zeros(Bp, bool)
    live0[: len(codes_list)] = True
    out = aligner._align_automaton(
        fmi, svc.bank, jnp.asarray(lens), jnp.asarray(live0),
        jnp.int32(len(g)), anchor_len=12, resolve=False, cap_steps=6,
    )
    assert int(np.asarray(out[10])[: len(codes_list)].sum()) > 0

    got = aligner.align_reads(fmi, g, reads, engine="device",
                              with_strand=True)
    for k, (h, d) in enumerate(zip(want, got)):
        assert h[0] == d[0] and h[2] == d[2], (k, h, d)
        assert str(h[1]) == str(d[1]) if h[1] else d[1] is None, (k, h, d)

    # rnaseq driver: same property
    rreads = [r[:50] for r in reads if len(r) >= 50]
    rwant = rnaseq.rna_seq(fmi, rreads, engine="device")
    monkeypatch.setattr(rnaseq, "_TEST_CAP", 4)
    _, capped = rnaseq._rna_seq_automaton(
        fmi,
        jnp.asarray(np.stack(
            [np.pad(codec.encode_read(r).astype(np.int32), (0, 64 - 50))
             for r in rreads[:8]])),
        jnp.full((8,), 50, jnp.int32), jnp.ones((8,), bool),
        ac=14, cc=10, resolve=False, cap_steps=4,
    )
    assert int(np.asarray(capped).sum()) > 0
    rgot = rnaseq.rna_seq(fmi, rreads, engine="device")
    np.testing.assert_array_equal(rwant, rgot)


def test_rna_seq_device_compaction_matches_host(genome_env, rng,
                                                monkeypatch):
    """The rnaseq automaton's two-stage live-lane compaction must be
    bit-identical to the host engine (forced with a lowered
    threshold); the mix includes hunt-exhausting junk reads — the
    stragglers the compaction exists for."""
    g, fmi, _, _, _ = genome_env
    assert fmi.isa_samples is not None
    monkeypatch.setattr(rnaseq, "_COMPACT_AT", 64)
    reads = []
    for _ in range(110):
        j = int(rng.integers(0, len(g) - 55))
        r = list(g[j : j + 50])
        k = int(rng.integers(0, len(r)))
        r[k] = "ACGT"[int(rng.integers(0, 4))]
        reads.append("".join(r))
    for _ in range(40):  # straggler lanes
        reads.append(
            "".join("ACGT"[int(c)] for c in rng.integers(0, 4, size=50))
        )
    host = rnaseq.rna_seq(fmi, reads, engine="host")
    dev = rnaseq.rna_seq(fmi, reads, engine="device")
    np.testing.assert_array_equal(host, dev)


def test_rna_seq_device_pipeline_matches_host(genome_env, rng):
    """Chunk-pipelined rna_seq_device (len > config.search_batch) must
    be order-preserving and bit-identical to the host engine."""
    import dataclasses

    from bwt_tpu.config import DEFAULT

    g, fmi, _, _, _ = genome_env
    assert fmi.isa_samples is not None
    cfg = dataclasses.replace(DEFAULT, search_batch=40)
    reads = []
    for _ in range(130):
        j = int(rng.integers(0, len(g) - 55))
        r = list(g[j : j + 50])
        k = int(rng.integers(0, len(r)))
        r[k] = "ACGT"[int(rng.integers(0, 4))]
        reads.append("".join(r))
    host = rnaseq.rna_seq(fmi, reads, engine="host")
    dev = rnaseq.rna_seq(fmi, reads, engine="device", config=cfg)
    np.testing.assert_array_equal(host, dev)


def test_search_reads_properties(genome_env, rng):
    g, fmi, _, _, _ = genome_env
    # clean 60-mers from the genome: forward anchors at the origin
    reads, origins = [], []
    for _ in range(30):
        j = int(rng.integers(0, len(g) - 60))
        reads.append(g[j : j + 60])
        origins.append(j)
    r = exact.search_reads(fmi, reads)
    assert all(r["fwd_matches"] >= 1)
    # the *last* anchor found covers the read's head: its position is
    # within the read span
    for b, j in enumerate(origins):
        assert j <= r["fwd_pos"][b] < j + 60
    # palindromic pairing: a read plus its plain reverse 100 bp later
    rev_read = reads[0][::-1]
    combo = exact.search_reads(fmi, [reads[0]])
    assert combo["fwd_matches"][0] >= 1

    out = exact.format_ref_output(reads, r)
    assert out.startswith("Beginning alignment\n")


def test_anchor_scan_matches_host_loop(genome_env, rng):
    g, fmi, _, _, _ = genome_env
    from host_ref import HostFMI

    codes = codec.encode_genome(g[:600])
    host = HostFMI(codes)
    small = bwt_tpu.build_index(codes)
    reads = []
    for _ in range(15):
        j = int(rng.integers(0, 600 - 40))
        r = list(codes[j : j + 40])
        if rng.random() < 0.5:
            r[int(rng.integers(0, 40))] ^= 3
        reads.append(r)
    # styles that pin the round-5 anchor-scan rework: trailing/inner
    # N runs (the gather-free trailing_n path), all-junk reads (the
    # deferred unc_sa's nmatch==0 -> -1 path), and a read whose only
    # anchor sits at the very first trip
    for _ in range(9):
        j = int(rng.integers(0, 600 - 40))
        r = list(codes[j : j + 40])
        style = int(rng.integers(0, 3))
        if style == 0:  # trailing + inner N run
            for k in range(int(rng.integers(1, 6))):
                r[39 - k] = 5
            r[int(rng.integers(0, 30))] = 5
        elif style == 1:  # junk: anchors nothing
            r = [int(x) for x in rng.integers(0, 4, 40)]
        reads.append(r)
    pat = np.zeros((len(reads), 40), np.int32)
    for b, r in enumerate(reads):
        pat[b] = r
    lens = np.full((len(reads),), 40, np.int32)
    nm, pos = exact.anchor_scan(small, pat, lens)
    nm, pos = np.asarray(nm), np.asarray(pos)
    for b, r in enumerate(reads):
        # independent host replay of the anchor loop
        ln, cnt, p = 40, 0, -1
        while ln > 20:
            m, sp, ep = host.mms(r[:ln])
            if m >= 20:
                cnt += 1
                p = host.unc_sa(sp)
                ln -= m
            else:
                ln -= 1
        assert (nm[b], pos[b]) == (cnt, p)


def test_single_align_parity_large(tmp_path, rng):
    """Second, larger single_align parity config: 60 kb genome, 120
    reads, heavier mutation — guards the aligner's rarer branches."""
    g = codec.random_genome(60000, seed=123)
    seqfile = tmp_path / "g60.txt"
    seqfile.write_text(g)
    fmi = bwt_tpu.build_index(g)
    idxfile = tmp_path / "g60.idx"
    bio.write_ref_index(fmi, idxfile)
    reads = make_reads(rng, g, 120, minlen=35, maxlen=120, junk_frac=0.15)
    readfile = tmp_path / "reads60.txt"
    readfile.write_text("\n".join(reads) + "\n")
    res = subprocess.run(
        [str(oracle("single_align")), str(seqfile), str(idxfile), str(readfile)],
        capture_output=True, check=True,
    )
    got = aligner.format_ref_output(aligner.align_reads(fmi, g, reads))
    assert got == res.stdout.decode()


def test_single_align_parity_n_heavy(tmp_path, rng):
    """N-dense reads through the (N-safe) anchored path: parity vs the
    C binary, which maps non-ACGT read chars to code 5 like we do."""
    g = codec.random_genome(25000, seed=77)
    seqfile = tmp_path / "gn.txt"
    seqfile.write_text(g)
    fmi = bwt_tpu.build_index(g)
    idxfile = tmp_path / "gn.idx"
    bio.write_ref_index(fmi, idxfile)
    reads = []
    for _ in range(50):
        rl = int(rng.integers(45, 95))
        j = int(rng.integers(0, len(g) - rl))
        r = list(g[j : j + rl])
        for _ in range(int(rng.integers(1, 5))):
            r[int(rng.integers(0, rl))] = "N"
        reads.append("".join(r))
    readfile = tmp_path / "rn.txt"
    readfile.write_text("\n".join(reads) + "\n")
    res = subprocess.run(
        [str(oracle("single_align")), str(seqfile), str(idxfile), str(readfile)],
        capture_output=True, check=True,
    )
    got = aligner.format_ref_output(aligner.align_reads(fmi, g, reads))
    assert got == res.stdout.decode()


@pytest.fixture(scope="module")
def repeat_env(tmp_path_factory):
    """A genome with a duplicated 3 kb segment and a 60-mer x 25
    tandem repeat — wide locate intervals, multi-match anchors, and
    ambiguous proximity checks on every driver path."""
    tmp = tmp_path_factory.mktemp("rep")
    r = np.random.default_rng(7)
    base = "".join("ACGT"[c] for c in r.integers(0, 4, size=6000))
    g = base + base[1000:4000] + base[4500:4560] * 25 + base[:800]
    seqfile = tmp / "genome.txt"
    seqfile.write_text(g)
    fmi = bwt_tpu.build_index(g)
    idxfile = tmp / "genome.idx"
    bio.write_ref_index(fmi, idxfile)
    return g, fmi, seqfile, idxfile, tmp


def _repeat_reads(rng, g, n=90):
    """Reads biased into the duplicated / tandem regions."""
    reads = []
    hot = [(1000, 4000), (6000, 9000), (9000, 10500)]
    for _ in range(n):
        lo, hi = hot[int(rng.integers(0, len(hot)))]
        rl = int(rng.integers(40, 90))
        j = int(rng.integers(lo, hi - rl))
        r = g[j : j + rl]
        if rng.random() < 0.5:
            r = _mutate(rng, r, int(rng.integers(1, 4)))
        reads.append(r)
    reads += make_reads(rng, g, 40)
    return [r for r in reads if r]


def test_single_align_parity_repetitive(repeat_env, rng):
    """single_align stdout byte parity on the repeat-heavy genome:
    multi-match anchor intervals must resolve in the reference's scan
    order (the isa_window equivalence, PARITY.md) and the
    genomic-proximity backward extension must pick the same copy."""
    g, fmi, seqfile, idxfile, tmp = repeat_env
    reads = _repeat_reads(rng, g)
    readfile = tmp / "reads_rep.txt"
    readfile.write_text("\n".join(reads) + "\n")
    res = subprocess.run(
        [str(oracle("single_align")), str(seqfile), str(idxfile), str(readfile)],
        capture_output=True, check=True,
    )
    got = aligner.format_ref_output(aligner.align_reads(fmi, g, reads))
    assert got == res.stdout.decode()
    dev = aligner.align_reads(fmi, g, reads, engine="device")
    host = aligner.align_reads(fmi, g, reads, engine="host")
    assert [(p, str(c) if c else None) for p, c in dev] == \
        [(p, str(c) if c else None) for p, c in host]


def test_rna_seq_parity_repetitive(repeat_env, rng):
    """rna_seq value parity on the repeat-heavy genome (gap re-anchors
    land in wide intervals; the position-aware continue must pick the
    reference's entry)."""
    g, fmi, seqfile, _, tmp = repeat_env
    reads = []
    for _ in range(60):
        lo, hi = [(1000, 4000), (6000, 9000), (9000, 10500)][_ % 3]
        j = int(rng.integers(lo, hi - 50))
        r = list(g[j : j + 50])
        k = 20 + int(rng.integers(0, 10))
        r[k] = "ACGT"[("ACGT".index(r[k])) ^ 3]  # rnaseqtest.c:321-322
        reads.append("".join(r))
    readfile = tmp / "reads_rna_rep.txt"
    readfile.write_text("\n".join(reads) + "\n")
    res = subprocess.run(
        [str(oracle("rnaseq_main")), str(seqfile), str(readfile)],
        capture_output=True, check=True,
    )
    want = [
        int(t) for t in res.stdout.decode().replace("Should be right?", " ").split()
    ]
    got = list(rnaseq.rna_seq(fmi, reads))
    assert got == want


def test_sam_output(genome_env, rng):
    """SAM records agree with align_reads: FLAG strand, POS, CIGAR."""
    from bwt_tpu.utils import sam

    g, fmi, seqfile, idxfile, tmp = genome_env
    reads = make_reads(rng, g, 30)
    res3 = aligner.align_reads(fmi, g, reads, with_strand=True)
    res2 = aligner.align_reads(fmi, g, reads)
    assert [(p, c.render() if c else None) for p, c, _ in res3] == [
        (p, c.render() if c else None) for p, c in res2
    ]
    text = sam.format_sam(res3, reads, ref_name="g", ref_len=fmi.length)
    lines = [l for l in text.splitlines() if not l.startswith("@")]
    assert len(lines) == len(reads)
    comp = str.maketrans("ACGTN", "TGCAN")
    for line, (pos, cig, rev), read in zip(lines, res3, reads):
        f = line.split("\t")
        if pos:
            assert int(f[1]) == (16 if rev else 0)
            assert int(f[3]) == pos
            assert f[5] == cig.render()
            # SEQ is reference-oriented: reverse hits emit revcomp
            want = read.translate(comp)[::-1] if rev else read
            assert f[9] == want
        else:
            assert int(f[1]) == 4 and f[3] == "0"
            assert f[9] == read


def test_cli_sam_and_fastq(genome_env, rng, tmp_path):
    import subprocess as sp
    import sys as _sys

    g, fmi, seqfile, idxfile, tmp = genome_env
    reads = make_reads(rng, g, 12)
    fq = tmp_path / "r.fq"
    fq.write_text(
        "".join(f"@r{i}\n{r}\n+\n{'I'*len(r)}\n" for i, r in enumerate(reads))
    )
    import os

    env = dict(os.environ, PYTHONPATH="", JAX_PLATFORMS="cpu")
    out = sp.run(
        [_sys.executable, "-m", "bwt_tpu", "single_align", str(seqfile),
         str(idxfile), str(fq), "--sam"],
        capture_output=True, text=True, env=env, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr[-500:]
    body = [l for l in out.stdout.splitlines() if not l.startswith("@")]
    assert len(body) == len(reads)
    want = aligner.align_reads(fmi, g, reads, with_strand=True)
    for line, (pos, cig, rev) in zip(body, want):
        f = line.split("\t")
        assert int(f[3]) == pos


def test_isa_path_matches_scan_path(genome_env, rng):
    """The inverse-SA window query must give the identical alignments
    and rnaseq values as the unc_sa interval scan (the reference's
    algorithm)."""
    import dataclasses

    g, fmi, *_ = genome_env
    assert fmi.isa_samples is not None
    fmi_noisa = dataclasses.replace(fmi, isa_samples=None)
    reads = make_reads(rng, g, 60)
    a = aligner.align_reads(fmi, g, reads)
    b = aligner.align_reads(fmi_noisa, g, reads)
    assert [(p, c.render() if c else None) for p, c in a] == [
        (p, c.render() if c else None) for p, c in b
    ]
    rreads = []
    for _ in range(40):
        j = int(rng.integers(0, len(g) - 50))
        r = list(g[j : j + 50])
        k = int(rng.integers(0, 50))
        r[k] = "ACGT"[("ACGT".index(r[k])) ^ int(rng.integers(1, 4))]
        rreads.append("".join(r))
    assert list(rnaseq.rna_seq(fmi, rreads)) == list(
        rnaseq.rna_seq(fmi_noisa, rreads)
    )


def test_isa_spec_depth_invariant(genome_env, rng):
    """The curgap loop's speculative chunk size (config.isa_spec_depth)
    only changes round batching; replies are consumed in the sequential
    loop's order, so outputs must be identical at every depth."""
    import dataclasses

    from bwt_tpu.config import DEFAULT

    g, fmi, *_ = genome_env
    assert fmi.isa_samples is not None
    reads = make_reads(rng, g, 60)
    outs = []
    for depth in (1, 3, 9):
        cfg = dataclasses.replace(DEFAULT, isa_spec_depth=depth)
        res = aligner.align_reads(fmi, g, reads, config=cfg)
        outs.append([(p, c.render() if c else None) for p, c in res])
    assert outs[1] == outs[0]
    assert outs[2] == outs[0]


def test_spec_depth_invariant(genome_env, rng):
    """Speculative retry batching (batch_exec "par") must be invisible
    in the outputs at any depth: the drivers consume exactly the reply
    prefix the sequential loop would have issued."""
    import dataclasses

    from bwt_tpu.config import Config

    g, fmi, *_ = genome_env
    reads = make_reads(rng, g, 50)
    outs = []
    for depth in (1, 3, 9):
        cfg = Config(spec_depth=depth)
        res = aligner.align_reads(fmi, g, reads, config=cfg)
        outs.append([(p, c.render() if c else None) for p, c in res])
    assert outs[0] == outs[1] == outs[2]

    rreads = []
    for _ in range(40):
        j = int(rng.integers(0, len(g) - 50))
        r = list(g[j : j + 50])
        for _k in range(int(rng.integers(1, 4))):
            k = int(rng.integers(0, 50))
            r[k] = "ACGT"[("ACGT".index(r[k])) ^ int(rng.integers(1, 4))]
        rreads.append("".join(r))
    rnas = [
        list(rnaseq.rna_seq(fmi, rreads, config=Config(rnaseq_spec_depth=d)))
        for d in (1, 4, 16)
    ]
    assert rnas[0] == rnas[1] == rnas[2]
    # the no-isa scan path composes with speculation too
    fmi_noisa = dataclasses.replace(fmi, isa_samples=None)
    res = aligner.align_reads(
        fmi_noisa, g, reads, config=Config(spec_depth=5)
    )
    assert [(p, c.render() if c else None) for p, c in res] == outs[0]


def test_rle_device_matches_host(rng):
    """The device-side backtrack RLE (compact nrun/vals/counts +
    raw-ops fallback for > _RLE_R-run lanes) must reproduce the host
    RLE exactly — including alternating 1-step ops that overflow the
    compact window."""
    import jax.numpy as jnp

    from bwt_tpu.models.batch_exec import (
        _OP_CHARS, _RLE_R, _ops_to_runs, _rle_device,
    )

    for trial in range(10):
        B = int(rng.integers(1, 10))
        S = int(rng.integers(2, 70))
        ops = np.full((B, S), 3, np.int8)
        for b in range(B):
            mode = rng.random()
            if mode < 0.15:
                continue  # all-dead row
            lo = int(rng.integers(0, S))
            hi = int(rng.integers(lo, S + 1))
            if mode < 0.5:  # alternating -> many runs (overflow path)
                ops[b, lo:hi] = [(0, 1, 2)[k % 3] for k in range(hi - lo)]
            else:
                ops[b, lo:hi] = rng.integers(0, 3, size=hi - lo)
        nrun, vals, counts = (
            np.asarray(x) for x in _rle_device(jnp.asarray(ops))
        )
        for b in range(B):
            want = _ops_to_runs(ops[b], 0, 0)
            if nrun[b] > _RLE_R:
                assert len(want) > _RLE_R  # fallback would trigger
                continue
            got = [
                (_OP_CHARS[vals[b, t]], int(counts[b, t]))
                for t in range(nrun[b])
            ]
            assert got == want, (trial, b)

    # int16-overflow guard: a run longer than the int16-safe bound (or
    # >32000 runs) must be routed to the raw-ops fallback by reporting
    # nrun > _RLE_R — never a silently wrapped count
    ops = np.full((2, 40000), 3, np.int8)
    ops[0, :39000] = 0           # one 39000-step run: count would wrap
    ops[1, :10] = [0, 1] * 5     # normal row stays on the compact path
    nrun, vals, counts = (
        np.asarray(x) for x in _rle_device(jnp.asarray(ops))
    )
    assert nrun[0] > _RLE_R
    assert nrun[1] == 10 and counts[1, 0] == 1
