"""bwt_tpu — an FM-index sequence-search engine in JAX.

A brand-new JAX / XLA / Pallas framework with the capabilities of the C
reference `yichizhng/bwt`: 2-bit nucleotide codecs, massively-parallel
suffix-array construction (prefix doubling on device), BWT derivation,
an FM-index whose rank/Occ queries are single fused-bucket row-gathers,
batched backward search / locate over thousands of reads per step,
k-mer seed tables, and seed-and-extend alignment with DP stitching and
CIGAR output.

Scales over a `jax.sharding.Mesh`: index replicated (or sharded) per
device, read batches data-parallel, hit lists merged with collectives.

Quick start::

    import bwt_tpu
    from bwt_tpu.ops import search

    fmi = bwt_tpu.build_index(genome_text)
    table = search.build_seed_table(fmi, k=8)
    positions = search.locate(fmi, read_codes, read_lens, seed_table=table)
"""

__version__ = "0.1.0"

from bwt_tpu import codec
from bwt_tpu.config import Config, DEFAULT as DEFAULT_CONFIG
from bwt_tpu.index import FMIndex, build_index, index_from_parts
from bwt_tpu.io import (
    read_npz_index,
    read_ref_index,
    write_npz_index,
    write_ref_index,
)
from bwt_tpu.ops.rank import rank as fm_rank

__all__ = [
    "codec",
    "Config",
    "DEFAULT_CONFIG",
    "FMIndex",
    "build_index",
    "index_from_parts",
    "read_npz_index",
    "read_ref_index",
    "write_npz_index",
    "write_ref_index",
    "fm_rank",
]
