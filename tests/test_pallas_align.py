"""The device DP fill (ops.align.dp_fill_diagonals, the one fill the
executor and the aligner's phase B run) and the executor's DP step
against the host numpy DP (ops.align.dp_fill / nw_fast / sw_fast)."""

import jax.numpy as jnp
import numpy as np

from bwt_tpu.ops import align
from bwt_tpu.utils.cigar import Cigar


def _batch(rng, B, L1, L2):
    reads = np.zeros((B, L1), np.int32)
    genomes = np.zeros((B, L2), np.int32)
    rl = np.zeros((B,), np.int32)
    gl = np.zeros((B,), np.int32)
    for b in range(B):
        l1 = int(rng.integers(1, L1 + 1))
        l2 = int(rng.integers(1, L2 + 1))
        reads[b, :l1] = rng.integers(0, 4, size=l1)
        if rng.random() < 0.3:
            reads[b, int(rng.integers(0, l1))] = 5
        genomes[b, :l2] = rng.integers(0, 4, size=l2)
        rl[b], gl[b] = l1, l2
    return reads, genomes, rl, gl


def diag_to_matrix(x_d, b, l1, l2):
    """Per-diagonal ``[d, i, b]`` -> pair b's (l1+1, l2+1) matrix."""
    i = np.arange(l1 + 1)[:, None]
    j = np.arange(l2 + 1)[None, :]
    return np.asarray(x_d)[i + j, i, b]


def test_wavefront_matches_xla_fill(rng):
    """Every cell of every pair equals the host fill of that pair's
    true-length read and genome (padding never leaks into them)."""
    B, L1, L2 = 12, 17, 23
    reads, genomes, rl, gl = _batch(rng, B, L1, L2)
    vals_d, ptrs_d = align.dp_fill_diagonals(reads, genomes)
    assert vals_d.shape == (L1 + L2 + 1, L1 + 1, B)
    for b in range(B):
        want_v, want_p = align.dp_fill(reads[b, : rl[b]], genomes[b, : gl[b]])
        assert np.array_equal(diag_to_matrix(vals_d, b, rl[b], gl[b]), want_v), b
        assert np.array_equal(diag_to_matrix(ptrs_d, b, rl[b], gl[b]), want_p), b
    # the matrix-layout view is the same fill
    mv, mp = align.dp_fill_batch(reads, genomes)
    for b in range(B):
        assert np.array_equal(np.asarray(mv)[b],
                              diag_to_matrix(vals_d, b, L1, L2))
        assert np.array_equal(np.asarray(mp)[b],
                              diag_to_matrix(ptrs_d, b, L1, L2))


def test_pallas_nw_batch_matches_host(rng):
    B, L1, L2 = 10, 14, 20
    reads, genomes, rl, gl = _batch(rng, B, L1, L2)
    endpos, cigars = align.nw_fast_batch(reads, rl, genomes, gl)
    for b in range(B):
        c = Cigar()
        want = align.nw_fast(reads[b, : rl[b]], genomes[b, : gl[b]], c)
        assert endpos[b] == want
        assert cigars[b].render() == c.render()


def test_wavefront_tiny_shapes(rng):
    # single pair, smallest shapes: D = L1+L2+1 edges
    reads = np.array([[1, 2]], np.int32)
    genomes = np.array([[1, 2, 3]], np.int32)
    vals_d, ptrs_d = align.dp_fill_diagonals(reads, genomes)
    want_vals, want_ptrs = align.dp_fill(reads[0], genomes[0])
    assert np.array_equal(diag_to_matrix(vals_d, 0, 2, 3), want_vals)
    assert np.array_equal(diag_to_matrix(ptrs_d, 0, 2, 3), want_ptrs)


def test_executor_dp_pallas_impl_matches_xla(rng):
    """The executor's batched DP step (slice gather, diagonal fill,
    endpoint scan, device backtrack, device RLE) gives the host DP's
    endpoint and CIGAR runs for every job: NW and SW, forward and
    reversed slices, reads with N."""
    from bwt_tpu.models.batch_exec import _OP_CHARS, _RLE_R, _dp_step

    J, L1, L2, Lb = 24, 32, 48, 40
    bank = rng.integers(0, 4, size=(6, Lb)).astype(np.int32)
    bank[rng.random(bank.shape) < 0.03] = 5
    genome = rng.integers(0, 4, size=500).astype(np.int32)
    row = rng.integers(0, 6, size=J).astype(np.int32)
    roff = rng.integers(0, 12, size=J).astype(np.int32)
    rlen = np.minimum(rng.integers(1, L1 + 1, size=J), Lb - roff).astype(
        np.int32)
    rrev = rng.integers(0, 2, size=J).astype(np.int32)
    glen = rng.integers(1, L2 + 1, size=J).astype(np.int32)
    gstart = rng.integers(0, 500 - L2, size=J).astype(np.int32)
    grev = rng.integers(0, 2, size=J).astype(np.int32)
    want_nw = rng.integers(0, 2, size=J).astype(np.int32)

    out = _dp_step(
        jnp.asarray(bank), jnp.asarray(genome),
        *(jnp.asarray(x) for x in
          (row, roff, rlen, rrev, gstart, glen, grev, want_nw)),
        L1=L1, L2=L2,
    )
    maxloc, i_res, j_res, nrun, vals, counts, _ops = map(np.asarray, out)
    for k in range(J):
        read = bank[row[k], roff[k] : roff[k] + rlen[k]]
        g = genome[gstart[k] : gstart[k] + glen[k]]
        if rrev[k]:
            read = read[::-1]
        if grev[k]:
            g = g[::-1]
        V, P = align.dp_fill(read, g)
        j = int(np.argmax(V[rlen[k]])) if want_nw[k] else int(glen[k])
        want = Cigar()
        align._backtrack(P, int(rlen[k]), j, want, flip=False)
        assert nrun[k] <= _RLE_R
        got = Cigar()
        for t in range(int(nrun[k])):
            got.push(_OP_CHARS[vals[k, t]], int(counts[k, t]))
        if i_res[k]:
            got.push("I", int(i_res[k]))
        if j_res[k]:
            got.push("D", int(j_res[k]))
        if want_nw[k]:
            assert maxloc[k] == j, k
        assert got.ops == want.ops, k


def test_dp_scan_unroll_is_invisible(rng, monkeypatch):
    """Unrolling the fill and backtrack scans changes no value: the
    executor's DP step and the fill agree at unroll 1 and 8."""
    import jax

    from bwt_tpu.models.batch_exec import _dp_step

    J, L1, L2, Lb = 16, 16, 32, 24
    bank = jnp.asarray(rng.integers(0, 4, size=(4, Lb)), jnp.int32)
    genome = jnp.asarray(rng.integers(0, 4, size=300), jnp.int32)
    cols = [jnp.asarray(x, jnp.int32) for x in (
        rng.integers(0, 4, size=J), np.zeros(J), rng.integers(1, L1 + 1, J),
        rng.integers(0, 2, J), rng.integers(0, 300 - L2, J),
        rng.integers(1, L2 + 1, J), rng.integers(0, 2, J),
        rng.integers(0, 2, J))]
    reads, genomes, _, _ = _batch(rng, 8, 11, 19)

    def run():
        return ([np.asarray(x) for x in
                 _dp_step(bank, genome, *cols, L1=L1, L2=L2)]
                + [np.asarray(x) for x in
                   align.dp_fill_diagonals(reads, genomes)])

    backend = jax.default_backend()
    outs = []
    for unroll in (1, 8):
        monkeypatch.setitem(align.DP_SCAN_UNROLL, backend, unroll)
        jax.clear_caches()
        assert align.dp_scan_unroll() == unroll
        outs.append(run())
    monkeypatch.undo()
    jax.clear_caches()
    for a, b in zip(*outs):
        assert np.array_equal(a, b)
