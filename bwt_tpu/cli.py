"""Command-line interface: one subcommand per reference binary.

Mirrors the reference's 12 Makefile targets (SURVEY.md section 1, L7)
as ``python -m bwt_tpu <cmd>``: the data tools (bwt, gen_seq, fil,
filread), the index builder, the search/alignment drivers
(search_reads, single_align, rnaseq, locate) and the self-checking
test/benchmark harnesses (searchtest, fmitest).  Output formats match
the reference binaries byte-for-byte where the reference's behavior is
defined (bwt, build_index artifacts, single_align stdout).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _force_platform(platform: str | None):
    """Pin JAX to ``platform`` ("cpu" or "gpu"; "auto" leaves JAX's
    own choice) and turn on the persistent compile cache."""
    import jax

    from bwt_tpu.utils import compile_cache

    if platform and platform != "auto":
        jax.config.update("jax_platforms", platform)
        compile_cache.enable(platform)
    else:
        compile_cache.enable()


def _read_genome(path: str) -> str:
    try:
        text = open(path, "r").read()
    except OSError:
        print("Could not open sequence", file=sys.stderr)  # single_align.c:379
        raise SystemExit(1)
    return text.rstrip("\n")


def _read_reads(path: str) -> list[str]:
    try:
        raw = open(path).read()
    except OSError:
        print("Could not open reads file", file=sys.stderr)  # single_align.c:434
        raise SystemExit(1)
    return [ln.rstrip("\r") for ln in raw.splitlines() if ln]


# --------------------------------------------------------------------------


def cmd_bwt(args):
    from bwt_tpu.ops.suffix import naive_bwt_ascii

    if not args.text:
        return 0  # bwt.c:43-44
    print(naive_bwt_ascii(args.text))  # puts() appends newline
    return 0


def cmd_gen_seq(args):
    from bwt_tpu import codec
    from bwt_tpu.config import DEFAULT

    n = args.length if args.length is not None else DEFAULT.gen_seq_default_len
    sys.stdout.write(codec.random_genome(n, seed=args.seed))
    return 0


def cmd_fil(args, per_header_newlines: bool = False):
    from bwt_tpu import codec

    fasta = open(args.input).read()
    if per_header_newlines:
        # filread.cc:46-49 keeps a newline per header line
        out = []
        for line in fasta.splitlines():
            if line.startswith(">"):
                out.append("\n")
            else:
                out.append(codec.fasta_to_text(line))
        text = "".join(out)
    else:
        text = codec.fasta_to_text(fasta)
    open(args.output, "w").write(text)
    return 0


def cmd_build_index(args):
    import bwt_tpu
    from bwt_tpu import io as bio

    t0 = time.perf_counter()
    dt = getattr(args, "index_dtype", "auto")
    if dt == "int64":
        import jax

        jax.config.update("jax_enable_x64", True)
    fmi = bwt_tpu.build_index(
        _read_genome(args.seqfile), sa_sample_rate=args.sa_rate,
        index_dtype=(np.int64 if dt == "int64"
                     else np.int32 if dt == "int32" else "auto"),
    )
    if args.format == "ref":
        bio.write_ref_index(fmi, args.indexfile)
    else:
        bio.write_npz_index(fmi, args.indexfile)
    print(
        f"Built index: {fmi.length} bases in {time.perf_counter()-t0:.2f}s",
        file=sys.stderr,
    )
    return 0


def _load(args):
    import bwt_tpu
    from bwt_tpu import io as bio

    if getattr(args, "indexfile", None):
        try:
            if args.indexfile.endswith(".npz"):
                return bio.read_npz_index(args.indexfile)
            return bio.read_ref_index(args.indexfile)
        except OSError:
            print("Could not open index file", file=sys.stderr)  # single_align.c:426
            raise SystemExit(1)
        except ValueError as e:
            # truncated / corrupt file: read_index returns NULL and the
            # drivers exit (fileio.c:57-60, single_align.c:427-430)
            print(str(e), file=sys.stderr)
            raise SystemExit(1)
    return bwt_tpu.build_index(_read_genome(args.seqfile))


def cmd_index_info(args):
    fmi = _load(args)
    print(
        json.dumps(
            dict(
                length=fmi.length,
                endloc=int(np.asarray(fmi.endloc)),
                C=[int(x) for x in np.asarray(fmi.C)],
                nwords=fmi.nwords,
                sa_samples=len(np.asarray(fmi.sa_samples)),
            )
        )
    )
    return 0


def cmd_search_reads(args):
    from bwt_tpu.models import exact

    fmi = _load(args)
    reads = _read_reads(args.readfile)
    res = exact.search_reads(
        fmi, reads, min_anchor=args.min_anchor, pair_window=args.pair_window
    )
    sys.stdout.write(exact.format_ref_output(reads, res))
    return 0


def _read_any_reads(path: str):
    """Reads file: newline-delimited text, or FastQ for .fq/.fastq.
    FastQ returns code arrays directly (align_reads accepts either)."""
    if path.endswith((".fq", ".fastq")):
        from bwt_tpu import native

        codes, lens = native.load_fastq(path)
        return [
            np.asarray(codes[b, : lens[b]], np.uint8)
            for b in range(codes.shape[0])
        ]
    return _read_reads(path)


def cmd_single_align(args):
    from bwt_tpu.models import aligner

    fmi = _load(args)
    genome = _read_genome(args.seqfile)
    reads = _read_any_reads(args.readfile)
    if getattr(args, "sam", False):
        from bwt_tpu.utils import sam

        res = aligner.align_reads(
            fmi, genome, reads, anchor_len=args.anchor_len, with_strand=True
        )
        sys.stdout.write(
            sam.format_sam(
                res, reads, ref_name=args.seqfile, ref_len=fmi.length
            )
        )
        naligned = sum(1 for p, _, _ in res if p)
    else:
        res = aligner.align_reads(fmi, genome, reads, anchor_len=args.anchor_len)
        sys.stdout.write(aligner.format_ref_output(res))
        naligned = sum(1 for p, _ in res if p)
    print(f"{naligned} of {len(reads)} reads aligned", file=sys.stderr)
    return 0


def cmd_rnaseq(args):
    from bwt_tpu.models import rnaseq

    fmi = _load(args)
    reads = _read_reads(args.readfile)
    for p in rnaseq.rna_seq(fmi, reads):
        print(int(p))
    return 0


def cmd_locate(args):
    from bwt_tpu import codec
    from bwt_tpu.models.exact import _encode_batch
    from bwt_tpu.ops import search

    fmi = _load(args)
    reads = _read_reads(args.readfile)
    pat, lens = _encode_batch(reads)
    pos = np.asarray(search.locate(fmi, pat, lens))
    for p in pos:
        print(int(p))
    return 0


def cmd_searchtest(args):
    """Self-check: locate() of sampled substrings returns their origin
    (searchtest.c:77-94)."""
    from bwt_tpu import codec
    from bwt_tpu.ops import search

    import bwt_tpu

    rng = np.random.default_rng(args.seed)
    codes = rng.integers(0, 4, size=args.length).astype(np.uint8)
    fmi = bwt_tpu.build_index(codes)
    bad = 0
    t0 = time.perf_counter()
    done = 0
    while done < args.queries:
        b = min(args.batch, args.queries - done)
        starts = rng.integers(0, args.length - args.plen, size=b)
        pats = np.stack([codes[s : s + args.plen] for s in starts]).astype(np.int32)
        lens = np.full((b,), args.plen, np.int32)
        pos = np.asarray(search.locate(fmi, pats, lens))
        for got, j in zip(pos, starts):
            if not np.array_equal(codes[got : got + args.plen], codes[j : j + args.plen]):
                print(f"Ruh roh {got} {j}")  # searchtest.c:87-88
                bad += 1
        done += b
    dt = time.perf_counter() - t0
    print(
        f"Searched {args.queries} sequences of length {args.plen} in {dt:.2f}s "
        f"({args.queries/dt:.0f}/s), {bad} mismatches",
        file=sys.stderr,
    )
    return 1 if bad else 0


def cmd_index_test(args):
    """File-loaded-index locate round-trip (index_test.c:88-106): load
    the index, sample plen-mers from the sequence, check locate()
    finds an occurrence of each."""
    from bwt_tpu.ops import search

    fmi = _load(args)
    text = _read_genome(args.seqfile)
    from bwt_tpu import codec

    codes = codec.encode_genome(text)
    rng = np.random.default_rng(args.seed)
    bad = 0
    t0 = time.perf_counter()
    done = 0
    while done < args.queries:
        b = min(args.batch, args.queries - done)
        starts = rng.integers(0, len(codes) - args.plen, size=b)
        pats = np.stack([codes[s : s + args.plen] for s in starts]).astype(np.int32)
        lens = np.full((b,), args.plen, np.int32)
        pos = np.asarray(search.locate(fmi, pats, lens))
        for got, j in zip(pos, starts):
            if not np.array_equal(
                codes[got : got + args.plen], codes[j : j + args.plen]
            ):
                print(f"Ruh roh {got} {j}")  # index_test.c:97-99
                bad += 1
        done += b
    dt = time.perf_counter() - t0
    print(
        f"Searched {args.queries} sequences of length {args.plen} in {dt:.2f}s, "
        f"{bad} mismatches",
        file=sys.stderr,
    )
    return 1 if bad else 0


def cmd_filetest(args):
    """Serialization round-trip (filetest.c:76-105): build, write to a
    temp file, read back, run the locate round-trip on the reloaded
    index."""
    import os
    import tempfile

    import bwt_tpu
    from bwt_tpu import io as bio
    from bwt_tpu.ops import search

    from bwt_tpu import codec

    text = _read_genome(args.seqfile)
    codes = codec.encode_genome(text)
    fmi = bwt_tpu.build_index(codes)
    fd, path = tempfile.mkstemp(suffix=".fmi")
    os.close(fd)
    try:
        bio.write_ref_index(fmi, path)
        fmi2 = bio.read_ref_index(path)
    finally:
        os.unlink(path)
    rng = np.random.default_rng(args.seed)
    b = min(args.queries, len(codes) - args.plen)
    starts = rng.integers(0, len(codes) - args.plen, size=b)
    pats = np.stack([codes[s : s + args.plen] for s in starts]).astype(np.int32)
    lens = np.full((b,), args.plen, np.int32)
    pos = np.asarray(search.locate(fmi2, pats, lens))
    bad = sum(
        0 if np.array_equal(codes[g : g + args.plen], codes[j : j + args.plen]) else 1
        for g, j in zip(pos, starts)
    )
    print(f"Round-trip: {b} queries, {bad} mismatches", file=sys.stderr)
    return 1 if bad else 0


def cmd_gaptest(args):
    """Gapped-read probe (gaptest.c:79-116): concatenate two plen-mers
    from different genome positions; mms must recover the second half
    as the maximal suffix, then the first half from the remainder."""
    import bwt_tpu
    from bwt_tpu.ops import search

    rng = np.random.default_rng(args.seed)
    codes = rng.integers(0, 4, size=args.length).astype(np.uint8)
    fmi = bwt_tpu.build_index(codes)
    half = args.plen
    n = args.queries
    a = rng.integers(0, args.length - half, size=n)
    b = rng.integers(0, args.length - half, size=n)
    pats = np.zeros((n, 2 * half), np.int32)
    for i in range(n):
        pats[i, :half] = codes[a[i] : a[i] + half]
        pats[i, half:] = codes[b[i] : b[i] + half]
    lens = np.full((n,), 2 * half, np.int32)
    m, sp, ep = (np.asarray(x) for x in search.mms(fmi, pats, lens))
    pos2 = np.asarray(search.unc_sa(fmi, sp))
    ok = 0
    for i in range(n):
        found = int(pos2[i])
        print(f"Second half: found {found} expected {b[i]} (matched {m[i]})")
        if m[i] >= half and np.array_equal(
            codes[found : found + half], codes[b[i] : b[i] + half]
        ):
            ok += 1
    m1, sp1, _ = (
        np.asarray(x) for x in search.mms(fmi, pats, np.full((n,), half, np.int32))
    )
    pos1 = np.asarray(search.unc_sa(fmi, sp1))
    for i in range(n):
        print(f"First half: found {pos1[i]} expected {a[i]} (matched {m1[i]})")
        if np.array_equal(
            codes[pos1[i] : pos1[i] + half], codes[a[i] : a[i] + half]
        ):
            ok += 1
    print(f"{ok} of {2*n} halves recovered", file=sys.stderr)
    return 0


def cmd_satest(args):
    """SA-construction cross-check + timing (the histtest.c /
    histsortcomptest.c role): build the suffix array on device, verify
    with the exact O(n) checker, and cross-check against a host sort
    for small inputs."""
    import jax

    from bwt_tpu.ops import suffix

    rng = np.random.default_rng(args.seed)
    codes = rng.integers(0, 4, size=args.length).astype(np.uint8)
    t0 = time.perf_counter()
    sa = suffix.suffix_array(codes)
    jax.block_until_ready(sa)
    dt = time.perf_counter() - t0
    ok = bool(suffix.verify_suffix_array(
        np.asarray(codes, np.int32), sa
    ))
    print(
        f"Suffix array of {args.length} bases in {dt:.2f}s "
        f"({args.length/dt/1e6:.2f} Mb/s), exact check: "
        f"{'ok' if ok else 'FAILED'}",
        file=sys.stderr,
    )
    if args.length <= 20_000:  # suffix-slice sort is O(n^2) memory
        text = bytes(codes).decode("latin1")
        want = sorted(range(len(text) + 1), key=lambda i: text[i:])
        match = np.array_equal(np.asarray(sa), np.asarray(want, np.int32))
        print(
            f"host-sort cross-check: {'ok' if match else 'FAILED'}",
            file=sys.stderr,
        )
        ok = ok and match
    return 0 if ok else 1


def cmd_differ(args):
    from bwt_tpu.utils import results

    for line, a, b in results.diff_positions(args.file1, args.file2):
        print(f"{line} {a} {b}")
    return 0


def cmd_proc_indices(args):
    from bwt_tpu.utils import results

    sys.stdout.write(
        results.format_histogram(
            results.hit_histogram(
                args.idxfile, min_count=args.min_count, gap=args.gap
            )
        )
    )
    return 0


def cmd_fmitest(args):
    """Index build + query throughput (fmitest.c:100-171)."""
    import jax

    import bwt_tpu
    from bwt_tpu.ops import search

    rng = np.random.default_rng(args.seed)
    codes = rng.integers(0, 4, size=args.length).astype(np.uint8)
    t0 = time.perf_counter()
    fmi = bwt_tpu.build_index(codes)
    jax.block_until_ready(fmi.bwt_words)
    print(
        f"Built index on {args.length} bp in {time.perf_counter()-t0:.2f}s",
        file=sys.stderr,
    )
    starts = rng.integers(0, args.length - 12, size=args.batch)
    pats = np.stack([codes[s : s + 12] for s in starts]).astype(np.int32)
    lens = np.full((args.batch,), 12, np.int32)
    counts = search.reverse_search(fmi, pats, lens)
    jax.block_until_ready(counts)
    t0 = time.perf_counter()
    steps = max(1, args.queries // args.batch)
    for _ in range(steps):
        counts = search.reverse_search(fmi, pats, lens)
    jax.block_until_ready(counts)
    dt = time.perf_counter() - t0
    print(
        f"Searched {steps*args.batch} 12bp sequences in {dt:.2f}s "
        f"({steps*args.batch/dt:.0f}/s)",
        file=sys.stderr,
    )
    return 0


# --------------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="bwt_tpu", description=__doc__)
    p.add_argument(
        "--platform", choices=["auto", "cpu", "gpu"], default="auto",
        help="force a JAX platform (default: auto)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("bwt", help="naive BWT of an ASCII string (bwt.c)")
    s.add_argument("text", nargs="?", default="")
    s.set_defaults(fn=cmd_bwt)

    s = sub.add_parser("gen_seq", help="random ACGT genome (gen_seq.c)")
    s.add_argument("length", nargs="?", type=int, default=None)
    s.add_argument("--seed", type=int, default=0)
    s.set_defaults(fn=cmd_gen_seq)

    s = sub.add_parser("fil", help="FastA -> plain sequence (fil.cc)")
    s.add_argument("input")
    s.add_argument("output")
    s.set_defaults(fn=cmd_fil)

    s = sub.add_parser("filread", help="FastA -> sequence w/ per-header newlines (filread.cc)")
    s.add_argument("input")
    s.add_argument("output")
    s.set_defaults(fn=lambda a: cmd_fil(a, per_header_newlines=True))

    s = sub.add_parser("build_index", help="build + serialize an FM-index")
    s.add_argument("seqfile")
    s.add_argument("indexfile")
    s.add_argument("--format", choices=["ref", "npz"], default="ref")
    s.add_argument(
        "--sa-rate", type=int, default=None,
        help="SA sample rate (power of two; 32 = reference; denser "
        "rates speed locate, npz format only for rates > 32... "
        "rates < 32 still export to ref format by downsampling)",
    )
    s.add_argument(
        "--index-dtype", choices=["auto", "int32", "int64"],
        default="auto",
        help="auto switches to the 64-bit-clean layout past the int32 "
        "cap (needs jax_enable_x64 and --format npz; the reference "
        "file format is int32 by definition)",
    )
    s.set_defaults(fn=cmd_build_index)

    s = sub.add_parser("index_info", help="print index metadata")
    s.add_argument("indexfile")
    s.set_defaults(fn=cmd_index_info)

    s = sub.add_parser("search_reads", help="batched exact anchor search (search_reads.c)")
    s.add_argument("seqfile")
    s.add_argument("indexfile", nargs="?")
    s.add_argument("readfile")
    s.add_argument("--min-anchor", type=int, default=None)
    s.add_argument("--pair-window", type=int, default=None)
    s.set_defaults(fn=cmd_search_reads)

    s = sub.add_parser("single_align", help="anchored seed-and-extend aligner (single_align.c)")
    s.add_argument("seqfile")
    s.add_argument("indexfile", nargs="?")
    s.add_argument("readfile")
    s.add_argument("--anchor-len", type=int, default=None)
    s.add_argument("--sam", action="store_true",
                   help="emit SAM records instead of the reference's "
                   "pos/CIGAR lines (reads files ending .fq/.fastq "
                   "parse as FastQ)")
    s.set_defaults(fn=cmd_single_align)

    s = sub.add_parser("rnaseq", help="spliced-alignment prototype (rnaseqtest.c)")
    s.add_argument("seqfile")
    s.add_argument("readfile")
    s.set_defaults(fn=cmd_rnaseq, indexfile=None)

    s = sub.add_parser("locate", help="locate each read (first match position)")
    s.add_argument("seqfile")
    s.add_argument("indexfile", nargs="?")
    s.add_argument("readfile")
    s.set_defaults(fn=cmd_locate)

    s = sub.add_parser("searchtest", help="locate round-trip self-check (searchtest.c)")
    s.add_argument("--length", type=int, default=100000)
    s.add_argument("--queries", type=int, default=10000)
    s.add_argument("--plen", type=int, default=30)
    s.add_argument("--batch", type=int, default=4096)
    s.add_argument("--seed", type=int, default=0)
    s.set_defaults(fn=cmd_searchtest)

    s = sub.add_parser("index_test", help="file-loaded-index locate round-trip (index_test.c)")
    s.add_argument("seqfile")
    s.add_argument("indexfile")
    s.add_argument("--queries", type=int, default=10000)
    s.add_argument("--plen", type=int, default=30)
    s.add_argument("--batch", type=int, default=4096)
    s.add_argument("--seed", type=int, default=0)
    s.set_defaults(fn=cmd_index_test)

    s = sub.add_parser("filetest", help="index serialization round-trip self-check (filetest.c)")
    s.add_argument("seqfile")
    s.add_argument("--queries", type=int, default=1000)
    s.add_argument("--plen", type=int, default=16)
    s.add_argument("--seed", type=int, default=0)
    s.set_defaults(fn=cmd_filetest)

    s = sub.add_parser("gaptest", help="gapped-read MMS recovery probe (gaptest.c)")
    s.add_argument("--length", type=int, default=100000)
    s.add_argument("--queries", type=int, default=10)
    s.add_argument("--plen", type=int, default=15)
    s.add_argument("--seed", type=int, default=0)
    s.set_defaults(fn=cmd_gaptest)

    s = sub.add_parser("satest", help="SA build cross-check + timing (histtest.c role)")
    s.add_argument("--length", type=int, default=100000)
    s.add_argument("--seed", type=int, default=0)
    s.set_defaults(fn=cmd_satest)

    s = sub.add_parser("differ", help="diff two position files (process_results/differ.cc)")
    s.add_argument("file1")
    s.add_argument("file2")
    s.set_defaults(fn=cmd_differ)

    s = sub.add_parser("proc_indices", help="hit-frequency histogram (process_results/proc_indices.cc)")
    s.add_argument("idxfile")
    s.add_argument("--min-count", type=int, default=10)
    s.add_argument("--gap", type=int, default=1000)
    s.set_defaults(fn=cmd_proc_indices)

    s = sub.add_parser("fmitest", help="build + 12-mer throughput (fmitest.c)")
    s.add_argument("--length", type=int, default=1_000_000)
    s.add_argument("--queries", type=int, default=100_000)
    s.add_argument("--batch", type=int, default=32768)
    s.add_argument("--seed", type=int, default=0)
    s.set_defaults(fn=cmd_fmitest)

    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _force_platform(args.platform)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
