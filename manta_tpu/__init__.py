"""manta_tpu: a structural-variant and indel caller with a JAX device path.

A from-scratch reimplementation of the capabilities of the Illumina Manta
SV caller (reference layout surveyed in SURVEY.md): host-side ingestion
of BAM/CRAM into packed read batches, vectorized evidence scanning, a
struct-of-arrays breakend graph, native de-Bruijn assembly and
Smith-Waterman-Gotoh alignment, with batched contig jump scoring on an
NVIDIA GPU (a CUDA kernel called through JAX's FFI) when one is present.
"""

__version__ = "0.1.0"
