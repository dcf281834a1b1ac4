"""Scan-position (sequence-parallel) sharding of split-read scoring.

The matrix-product junction kernel (align/device_splitscore_mxu) evaluates an
(R reads x S scan-positions) score matrix per junction. For very long
targets (large insertions, long homology tracts) S is the long axis —
the domain analogue of sequence length. This module shards S over a
mesh axis with ``shard_map``: every device scores ALL reads against its
contiguous slice of scan positions (the per-device grid offset rides in
through the kernel's ``s0`` operand), then one max + tie-lowest-position
combine runs over the mesh axis (``lax.pmax`` / masked ``lax.pmin`` —
collectives XLA hands to NCCL on GPUs).

Tie-breaking matches the single-device kernels: the winning position is
the LOWEST scan position among score ties, which argmax gives for free
within a shard and the masked pmin restores across shards.

Reference semantics: GenerateSVCandidates/SplitReadAlignment.cpp
(sliding scan); the parallel decomposition is this project's, no reference
equivalent (the reference is single-threaded per read here).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

# plain int (a jnp scalar here would initialize the JAX backend as an
# import side effect, pinning the platform before callers configure it)
_BIG_POS = 2**31 - 1


def junction_split_score_scan_parallel(
        mesh: Mesh, reads, quals, targets, s0, bp_beg, bp_end,
        read_len, target_len, flank_score_size, ln_match_lut, ln_mism_lut,
        n_scan: int, scan_axis: str = "scan",
        batch_axis: str | None = None):
    """Scan-parallel junction_split_score over ``mesh[scan_axis]``.

    Operands follow align/device_splitscore_mxu.junction_split_score.
    The junction batch dim G may additionally shard over
    ``mesh[batch_axis]`` (2-D edge x scan decomposition — the domain's
    data-parallel x sequence-parallel analogue). ``n_scan`` must divide
    evenly by the scan-axis size (pad targets / the grid to a multiple
    first — they are padded to tiers anyway).

    Returns (best_lnlhood, best_pos): (G, R) float32 / int32, equal to
    the single-device kernel output (bit-equal scores; positions equal
    under the lowest-position tie rule).
    """
    from ..align.device_splitscore_mxu import junction_split_score

    n_shards = mesh.shape[scan_axis]
    assert n_scan % n_shards == 0, (n_scan, n_shards)
    local_scan = n_scan // n_shards

    def local_step(reads, quals, targets, s0, bp_beg, bp_end,
                   read_len, target_len, lut_m, lut_x):
        # contiguous slice of the scan grid for this device
        shard = jax.lax.axis_index(scan_axis)
        local_s0 = s0 + shard * local_scan
        best, pos = junction_split_score(
            reads, quals, targets, local_s0, bp_beg, bp_end,
            read_len, target_len, flank_score_size, lut_m, lut_x,
            n_scan=local_scan)
        # combine: max score over shards; lowest position among ties.
        # -inf shards (no valid scan position locally) never win unless
        # ALL shards are -inf, in which case the global position falls
        # back to the lowest per-shard fallback (scan_start), matching
        # the single-device kernel.
        gbest = jax.lax.pmax(best, scan_axis)
        tie = best >= gbest  # >= keeps -inf==-inf fallback ties
        gpos = jax.lax.pmin(jnp.where(tie, pos, _BIG_POS), scan_axis)
        return gbest, gpos

    bspec = P(batch_axis) if batch_axis else P()
    fn = jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(bspec,) * 8 + (P(), P()), out_specs=bspec,
        check_vma=False)
    return fn(reads, quals, targets, s0, bp_beg, bp_end,
              read_len, target_len, ln_match_lut, ln_mism_lut)


