"""Bring-up check of the FM-index engine on NVIDIA GPUs.

Runs the engine's main path once, at chromosome scale, through the
entry points a user calls: a seeded synthetic genome, the FM-index
build, exact search and locate, the three drivers (``single_align``,
``rna_seq``, ``search_reads``) and the CLI.  Every result is checked
against an independent numpy reference or against the same driver on
the CPU backend, in this one process.  Any failed check raises.

    python chip_smoke.py                    # one GPU, 2^27-base genome
    python chip_smoke.py --genome 536870912 # up to 2^29 bases
    python chip_smoke.py --cards 4          # the multi-GPU paths only,
                                            # each against device 0

Exits non-zero, printing no result, when JAX finds no GPU.  The last
line of standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import pathlib
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

import bwt_tpu
from bwt_tpu import codec
from bwt_tpu.models import aligner, exact, rnaseq
from bwt_tpu.ops import search
from bwt_tpu.utils import compile_cache, profiling

ROOT = pathlib.Path(__file__).resolve().parent
MAX_GENOME = 1 << 29


# --------------------------------------------------------------------------
# independent references (numpy only; no index involved)
# --------------------------------------------------------------------------


def kmer_codes(genome: np.ndarray, k: int) -> np.ndarray:
    """Code of every k-mer window of ``genome`` (first base most
    significant, 2 bits a base), as uint32."""
    n = len(genome) - k + 1
    h = np.zeros(max(n, 0), np.uint32)
    for t in range(k):
        h <<= np.uint32(2)
        h |= genome[t : t + n]
    return h


def pattern_codes(pats: np.ndarray) -> np.ndarray:
    k = pats.shape[1]
    w = (np.uint32(4) ** np.arange(k - 1, -1, -1, dtype=np.uint32))
    return (pats.astype(np.uint32) * w).sum(axis=1, dtype=np.uint32)


def expected_reverse_search(genome: np.ndarray, pats: np.ndarray) -> np.ndarray:
    """What ``search.reverse_search`` must return for k-mer ``pats``,
    from k-mer histograms of the genome: occurrences + 1 for a present
    pattern (the reference's +1 quirk, seqindex.c:241); for an absent
    one, 1 if the interval emptied only at the final character (its
    (k-1)-suffix occurs) and 0 if it emptied earlier."""
    k = pats.shape[1]
    full = np.bincount(kmer_codes(genome, k), minlength=4 ** k)
    tail = np.bincount(kmer_codes(genome, k - 1), minlength=4 ** (k - 1))
    code = pattern_codes(pats)
    n_full = full[code]
    n_tail = tail[code & np.uint32(4 ** (k - 1) - 1)]
    return np.where(n_full > 0, n_full + 1, (n_tail > 0).astype(np.int64))


def occurs_at(genome: np.ndarray, pats: np.ndarray, pos) -> np.ndarray:
    """Per pattern: ``genome[p:p+L] == pattern`` at its position p."""
    pos = np.asarray(pos, np.int64)
    L = pats.shape[1]
    inside = (pos >= 0) & (pos + L <= len(genome))
    start = np.where(inside, pos, 0)
    win = genome[start[:, None] + np.arange(L)]
    return inside & (win == pats).all(axis=1)


def cigar_query_len(cigar) -> int:
    """Read bases a CIGAR consumes (M + I)."""
    return sum(n for op, n in cigar.ops if op in ("M", "I"))


def mutated_reads(genome, n, length, rng):
    """One XOR-ed base per read (the reference's rnaseqtest.c:317-322
    recipe)."""
    starts = rng.integers(0, len(genome) - length, size=n)
    reads = genome[np.add.outer(starts, np.arange(length))].copy()
    pos = rng.integers(0, length, size=n)
    reads[np.arange(n), pos] ^= rng.integers(1, 4, size=n).astype(np.uint8)
    return reads


def substrings(genome, n, length, rng):
    starts = rng.integers(0, len(genome) - length, size=n)
    return genome[np.add.outer(starts, np.arange(length))]


def rna_lines(vals) -> str:
    return "".join(f"{int(v)}\n" for v in vals)


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def _block(x):
    jax.block_until_ready(
        [a for a in jax.tree_util.tree_leaves(x) if isinstance(a, jax.Array)])
    return x


def cold_warm(fn):
    """Run ``fn`` twice: (result, first-call seconds incl. compile,
    second-call seconds)."""
    t0 = time.perf_counter()
    _block(fn())
    t1 = time.perf_counter()
    out = _block(fn())
    return out, t1 - t0, time.perf_counter() - t1


def report(phase, name, cold, warm, extra=""):
    print(f"phase {phase} {name}: setup+compile {cold:.3f} s, warm "
          f"{warm:.3f} s{extra}", flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def phase_build(genome):
    out = {}
    for rate in (32, 4):
        fmi, cold, warm = cold_warm(
            lambda: bwt_tpu.build_index(genome, sa_sample_rate=rate))
        peak = jax.devices()[0].memory_stats()["peak_bytes_in_use"]
        report(1, f"build rate {rate}", cold, warm,
               f", peak {peak} B, {len(genome) / warm / 1e6:.1f} Mb/s")
        counts = np.bincount(genome, minlength=4)
        want = np.concatenate([[1], 1 + np.cumsum(counts)])  # C[0] = 1
        check(np.array_equal(np.asarray(fmi.C)[:5], want),
              f"rate {rate}: C != cumulative base counts")
        out[rate] = fmi
    return out[32], out[4]


def phase_search(genome, fmi, rng, n=1 << 21, k=12):
    pats = rng.integers(0, 4, size=(n, k)).astype(np.uint8)
    want = expected_reverse_search(genome, pats)
    pats_d = jnp.asarray(pats, jnp.int32)
    lens_d = jnp.full((n,), k, jnp.int32)
    tiers = {"raw": None}
    for sk in (8, 12):
        tiers[f"k{sk}"] = _block(search.build_seed_table(fmi, k=sk))
    for name, st in tiers.items():
        got, cold, warm = cold_warm(
            lambda: search.reverse_search(fmi, pats_d, lens_d, seed_table=st))
        check(np.array_equal(np.asarray(got), want),
              f"reverse_search {name} != 12-mer histogram")
        report(2, f"search {name}", cold, warm,
               f", {n / warm / 1e6:.2f} M searches/s")


def phase_locate(genome, fmi32, fmi4, rng, n=1 << 19, L=30):
    pats = substrings(genome, n, L, rng)
    pats_d = jnp.asarray(pats, jnp.int32)
    lens_d = jnp.full((n,), L, jnp.int32)
    pos = {}
    for rate, fmi in ((32, fmi32), (4, fmi4)):
        got, cold, warm = cold_warm(lambda: search.locate(fmi, pats_d, lens_d))
        pos[rate] = np.asarray(got)
        check(occurs_at(genome, pats, pos[rate]).all(),
              f"locate rate {rate}: a position does not hold its pattern")
        report(3, f"locate rate {rate}", cold, warm,
               f", {n / warm / 1e6:.2f} M locates/s")
    check(np.array_equal(pos[32], pos[4]), "locate: rate 32 != rate 4")


def phase_drivers(genome, fmi4, rng, n=32768, n_cpu=256):
    """Returns the reads and the GPU results, for the CLI phase."""
    areads = mutated_reads(genome, n, 80, rng)
    rreads = np.ascontiguousarray(areads[:, :50])
    sreads = mutated_reads(genome, n, 100, rng)
    cpu = jax.devices("cpu")[0]
    fmi_cpu = jax.device_put(fmi4, cpu)
    engine = "automaton" if fmi4.isa_samples is not None else "host-generator"

    res, cold, warm = cold_warm(
        lambda: aligner.align_reads(fmi4, genome, areads))
    aligned = [c for p, c in res if p]
    check(all(cigar_query_len(c) == 80 for c in aligned),
          "single_align: a CIGAR's M+I != read length")
    with jax.default_device(cpu):
        want = aligner.format_ref_output(
            aligner.align_reads(fmi_cpu, genome, areads[:n_cpu]))
    check(aligner.format_ref_output(res[:n_cpu]) == want,
          "single_align: GPU output != CPU output")
    report(4, f"single_align ({engine})", cold, warm,
           f", {n / warm:.0f} reads/s, {len(aligned)}/{n} aligned")

    vals, cold, warm = cold_warm(lambda: rnaseq.rna_seq(fmi4, rreads))
    with jax.default_device(cpu):
        want = rna_lines(rnaseq.rna_seq(fmi_cpu, rreads[:n_cpu]))
    check(rna_lines(vals[:n_cpu]) == want, "rna_seq: GPU values != CPU values")
    report(4, f"rna_seq ({engine})", cold, warm, f", {n / warm:.0f} reads/s")

    sres, cold, warm = cold_warm(lambda: exact.search_reads(fmi4, sreads))
    with jax.default_device(cpu):
        want_arrays = exact.search_reads(fmi_cpu, sreads[:n_cpu])
    want = exact.format_ref_output(sreads[:n_cpu], want_arrays)
    head = {k: v[:n_cpu] for k, v in sres.items()}
    check(all(np.array_equal(head[k], want_arrays[k]) for k in head),
          "search_reads: GPU anchors != CPU anchors")
    check(exact.format_ref_output(sreads[:n_cpu], head) == want,
          "search_reads: GPU output != CPU output")
    report(4, "search_reads (device anchor scan)", cold, warm,
           f", {n / warm:.0f} reads/s, {int(sres['paired'].sum())} paired")
    return areads, res, sreads, sres


def _cli(argv) -> str:
    from bwt_tpu import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    check(rc == 0, f"cli {argv[0]} returned {rc}")
    return buf.getvalue()


def phase_cli(genome, areads, sa_res, sreads, sres, n=4096):
    with tempfile.TemporaryDirectory() as d:
        d = pathlib.Path(d)
        (d / "g.txt").write_text(codec.decode(genome))
        for name, reads in (("a.txt", areads[:n]), ("s.txt", sreads[:n])):
            (d / name).write_text(
                "".join(codec.decode(r) + "\n" for r in reads))
        t0 = time.perf_counter()
        _cli(["build_index", str(d / "g.txt"), str(d / "g.npz"),
              "--format", "npz", "--sa-rate", "4"])
        t1 = time.perf_counter()
        got = _cli(["single_align", str(d / "g.txt"), str(d / "g.npz"),
                    str(d / "a.txt")])
        check(got == aligner.format_ref_output(sa_res[:n]),
              "cli single_align != phase 4 rendering")
        t2 = time.perf_counter()
        got = _cli(["search_reads", str(d / "g.txt"), str(d / "g.npz"),
                    str(d / "s.txt")])
        head = {k: v[:n] for k, v in sres.items()}
        check(got == exact.format_ref_output(sreads[:n], head),
              "cli search_reads != phase 4 rendering")
        t3 = time.perf_counter()
    print(f"phase 5 cli: build_index {t1 - t0:.3f} s, single_align "
          f"{t2 - t1:.3f} s, search_reads {t3 - t2:.3f} s "
          f"({n} reads each, compile included)", flush=True)


def phase_gpu_tests():
    import pytest

    t0 = time.perf_counter()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      str(ROOT / "tests")])
    check(rc == 0, f"gpu-marked tests failed (pytest exit code {rc})")
    print(f"phase 6 gpu-marked tests: passed in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)


def run_one_card(genome, seed):
    rng = np.random.default_rng(seed + 1)
    fmi32, fmi4 = phase_build(genome)
    phase_search(genome, fmi32, rng)
    phase_locate(genome, fmi32, fmi4, rng)
    areads, sa_res, sreads, sres = phase_drivers(genome, fmi4, rng)
    phase_cli(genome, areads, sa_res, sreads, sres)
    phase_gpu_tests()


def run_four_cards(genome, seed, n_reads=32768, n_pats=1 << 19):
    """Each multi-device result against the one-device result computed
    on device 0 in this process."""
    from bwt_tpu import parallel
    from bwt_tpu.ops import suffix
    from bwt_tpu.parallel.suffix_dist import sharded_suffix_array

    rng = np.random.default_rng(seed + 1)
    fmi32 = _block(bwt_tpu.build_index(genome))
    fmi4 = _block(bwt_tpu.build_index(genome, sa_sample_rate=4))
    pats = substrings(genome, n_pats, 30, rng)
    lens = np.full((n_pats,), 30, np.int32)
    want_pos = np.asarray(search.locate(fmi32, pats, lens))
    want_cnt = np.asarray(search.count_matches(fmi32, pats, lens))

    for tp in (1, 2):
        mesh = parallel.make_mesh(4, tp=tp)
        fmi_m = (parallel.replicate_index if tp == 1 else
                 parallel.shard_index)(fmi32, mesh)
        p, l = parallel.shard_patterns(pats, lens, mesh)
        (pos, cnt, total), cold, warm = cold_warm(
            lambda: parallel.sharded_search_step(fmi_m, p, l, mesh))
        check(np.array_equal(parallel.gather_hits(pos), want_pos),
              f"sharded_search_step tp={tp}: positions != one card")
        check(np.array_equal(np.asarray(cnt), want_cnt),
              f"sharded_search_step tp={tp}: counts != one card")
        check(int(total) == int((want_pos >= 0).sum()),
              f"sharded_search_step tp={tp}: total != one card")
        report("4c", f"sharded_search_step dp={4 // tp} tp={tp}", cold, warm)

    mesh = parallel.make_mesh(4, tp=2)
    fmi_s = parallel.shard_index(fmi32, mesh)
    (pos, cnt), cold, warm = cold_warm(
        lambda: parallel.tp_locate(fmi_s, pats, lens, mesh))
    check(np.array_equal(np.asarray(pos), want_pos),
          "tp_locate: positions != one card")
    check(np.array_equal(np.asarray(cnt), want_cnt),
          "tp_locate: counts != one card")
    report("4c", "tp_locate dp=2 tp=2", cold, warm)

    reads = mutated_reads(genome, n_reads, 80, rng)
    want = aligner.format_ref_output(aligner.align_reads(fmi4, genome, reads))
    dp4 = parallel.make_mesh(4, tp=1)
    res, cold, warm = cold_warm(
        lambda: aligner.align_reads(fmi4, genome, reads, mesh=dp4))
    check(aligner.format_ref_output(res) == want,
          "align_reads mesh=dp4 != one card")
    report("4c", "align_reads mesh dp=4", cold, warm,
           f", {n_reads / warm:.0f} reads/s")

    want_sa = np.asarray(suffix.suffix_array(genome))
    tp4 = parallel.make_mesh(4, tp=4)
    sa, cold, warm = cold_warm(
        lambda: sharded_suffix_array(genome, tp4, axis="tp"))
    check(np.array_equal(sa, want_sa), "sharded_suffix_array != one card")
    report("4c", "sharded_suffix_array tp=4", cold, warm)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--genome", type=int, default=1 << 27,
                    help=f"genome length in bases (at most {MAX_GENOME})")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    args = ap.parse_args(argv)
    if not 1 << 16 <= args.genome <= MAX_GENOME:
        ap.error(f"--genome must be in [65536, {MAX_GENOME}]")

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < args.cards:
        print(f"chip_smoke: needs {args.cards} GPU(s); JAX found "
              f"{len(devs)} {devs[0].platform} device(s)", file=sys.stderr)
        return 1
    print(profiling.gpu_card(), flush=True)
    print(f"jax {jax.__version__}, device_kind {devs[0].device_kind}, "
          f"{len(devs)} device(s)", flush=True)
    compile_cache.enable()

    t0 = time.perf_counter()
    genome = np.random.default_rng(args.seed).integers(
        0, 4, size=args.genome, dtype=np.uint8)
    print(f"phase 0 genome: {args.genome} bases in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    if args.cards == 4:
        run_four_cards(genome, args.seed)
    else:
        run_one_card(genome, args.seed)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
