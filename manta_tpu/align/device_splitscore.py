"""Batched split-read likelihood scoring on device (JAX/XLA).

The device form of the phase-2 split-read scan: the sliding
basecall-likelihood scan of reads across breakpoint junction targets
(host reference implementation: scoring/evidence.py split_read_aligner;
reference semantics: GenerateSVCandidates/SplitReadAlignment.cpp).

Layout: everything is padded to fixed shapes and masked, so one jitted
program serves all edges:
  reads:   (B, L)  uint8 base codes, 0xFF padding
  quals:   (B, L)  uint8
  targets: (B, T)  uint8 target (contig or reference) sequence
  bp_beg/bp_end: (B,) int32 microhomology-aware breakend offset range
  read_len/target_len: (B,) int32

The scan positions k in [scan_start, scan_end] are evaluated in
parallel; per-base terms use precomputed ln-probability LUTs and a
score-range gate; accumulation is a sequential float32 lax.scan over
read bases, in the host scan's summation order, so results are
bit-identical. Outputs (best lnlhood, best pos) feed the flank/mismatch
bookkeeping, which stays on host (cheap, O(L)).

Sharding: batch dimension is data-parallel; see parallel/mesh.py.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

MAX_QSCORE = 70
PAD_BASE = 0xFF
N_BASE = ord("N")


def make_luts(snp_prob: float):
    """ln-likelihood LUTs indexed by clamped qscore
    (reference: blt_util/qscore_snp.cpp)."""
    comp_snp3 = 1.0 - snp_prob / 3.0
    q = np.arange(MAX_QSCORE + 1, dtype=np.float64)
    qerr = np.power(10.0, -q / 10.0)
    p = qerr * comp_snp3 + (1.0 - qerr) * snp_prob
    with np.errstate(divide="ignore"):
        # q<2 entries are -inf but unused: quals are clamped to [2,70]
        ln_match = np.log1p(-p) if snp_prob > 0 else np.log1p(-qerr)
        ln_mism = np.log(p) + math.log(1 / 3.0)
    return (jnp.asarray(ln_match, jnp.float32),
            jnp.asarray(ln_mism, jnp.float32))


LN_RANDOM = np.float32(-math.log(4.0))


@partial(jax.jit, static_argnames=("n_scan",))
def batched_split_score(reads, quals, targets, bp_beg, bp_end,
                        read_len, target_len, flank_score_size,
                        ln_match_lut, ln_mism_lut, n_scan: int):
    """Score all scan positions for a batch of read/target pairs.

    Returns (best_lnlhood, best_pos): (B,) float32 / int32.
    """
    B, L = reads.shape
    T = targets.shape[1]

    scan_start = jnp.maximum(0, bp_beg - read_len + 2)           # (B,)
    scan_end = jnp.maximum(0, jnp.minimum(bp_end, target_len - read_len))
    score_beg = bp_beg - flank_score_size
    score_end = bp_end + flank_score_size

    k = jnp.arange(n_scan, dtype=jnp.int32)                      # (S,)
    j = jnp.arange(L, dtype=jnp.int32)                           # (L,)
    # target positions per (b, k, j)
    tpos = scan_start[:, None, None] + k[None, :, None] + j[None, None, :]
    tpos_clamped = jnp.clip(tpos, 0, T - 1)
    win = jnp.take_along_axis(
        targets, tpos_clamped.reshape(B, n_scan * L), axis=-1
    ).reshape(B, n_scan, L)

    q = reads[:, None, :]
    qual_i = jnp.clip(quals.astype(jnp.int32), 2, MAX_QSCORE)
    lnm = ln_match_lut[qual_i][:, None, :]                       # (B,1,L)
    lnx = ln_mism_lut[qual_i][:, None, :]
    is_n = (q == N_BASE) | (win == N_BASE)
    mism = (q != win) | (q == N_BASE)
    terms = jnp.where(is_n, LN_RANDOM, jnp.where(mism, lnx, lnm))

    # gates: valid read bases, score-range window, valid scan positions
    base_valid = (j[None, None, :] < read_len[:, None, None])
    in_range = (tpos > score_beg[:, None, None]) & \
        (tpos <= score_end[:, None, None])
    terms = jnp.where(base_valid & in_range, terms, jnp.float32(0))

    # strict left-to-right float32 accumulation over bases: XLA's cumsum
    # lowers to a log-depth parallel prefix whose addition order differs
    # from the host scan's sequential loop by a few ULPs, so a lax.scan
    # over the (short) base axis keeps lnlhoods bit-identical while the
    # (B, S) planes stay fully vectorized
    def _acc(carry, plane):
        return carry + plane, None

    lnl, _ = jax.lax.scan(_acc, jnp.zeros((B, n_scan), jnp.float32),
                          jnp.moveaxis(terms, -1, 0))             # (B,S)
    scan_valid = k[None, :] <= (scan_end - scan_start)[:, None]
    lnl = jnp.where(scan_valid, lnl, -jnp.inf)
    best_k = jnp.argmax(lnl, axis=-1).astype(jnp.int32)
    best = jnp.take_along_axis(lnl, best_k[:, None], axis=-1)[:, 0]
    return best, scan_start + best_k
