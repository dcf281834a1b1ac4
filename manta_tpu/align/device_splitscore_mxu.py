"""Matrix-product ("mxu" mode) formulation of batched split-read scoring.

The exact kernel (device_splitscore.batched_split_score) evaluates the
sliding basecall-likelihood scan as a masked gather + elementwise
reduction — elementwise vector work. In production (scoring/scorer._score_split_reads)
every candidate read at a junction scores against the SAME target
sequences and the SAME microhomology range, which factors the scan into
per-symbol correlations and puts the FLOPs in matrix products:

  term(r, j, s) = gate(s+j) * [ lnx(r,j)
                                + (read_r[j] == target[s+j]) * delta(r,j)
                                + (target[s+j] == N) * nadj(r,j) ]

  with  delta = lnm - lnx,  nadj = LN_RANDOM - lnx  (both zeroed where
  the read base is N or past read_len; lnx := LN_RANDOM on read-N).

  score(r, s) = sum_j term
              = prefix-sum base part                     (O(R*S) gathers)
              + K(r, :) @ Tmat(:, s)                     (matmul)

  K    (R, 5L): 4 match channels (delta * onehot_c(read)) + 1 N channel
  Tmat (5L, S): gated target indicator Toeplitz
                Tmat[cL+j, s] = gate(s0+s+j) * onehot_c(target[s0+s+j])

Tmat entries are exactly representable in bf16 (0/1); K is split into
bf16 hi/lo halves (hi rounded in integer bit arithmetic; two matmuls
with explicit bf16 operands and float32 accumulation, so TF32 never
applies on a GPU), giving ~1e-4 absolute score accuracy — near-exact
but NOT bit-identical to the host scan's sequential float32 order (the
exact kernel remains the default for oracle-exact production scoring).

Reference semantics: GenerateSVCandidates/SplitReadAlignment.cpp
(sliding scan, qscore ln-likelihood terms, score-range gate).
Requires bases in {A,C,G,T,N}; callers must route other IUPAC codes to
the exact kernel.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .device_splitscore import LN_RANDOM, MAX_QSCORE, N_BASE

_ACGT = (65, 67, 71, 84)  # 'A' 'C' 'G' 'T'


@partial(jax.jit, static_argnames=("n_scan",))
def junction_split_score(reads, quals, targets, s0, bp_beg, bp_end,
                         read_len, target_len, flank_score_size,
                         ln_match_lut, ln_mism_lut, n_scan: int):
    """Score all scan positions for G junctions x R reads each.

    reads/quals: (G, R, L) uint8 (0xFF padded reads)
    targets:     (G, T) uint8, bp_beg/bp_end/target_len/s0: (G,) int32
    read_len:    (G, R) int32 (0 rows = padding reads)
    s0: absolute target offset of scan-grid position 0; the grid
        covers absolute positions [s0, s0 + n_scan).

    Returns (best_lnlhood, best_pos): (G, R) float32 / int32, with
    best_pos absolute (same convention as batched_split_score).
    """
    G, R, L = reads.shape
    T = targets.shape[1]
    S = n_scan

    score_beg = bp_beg - flank_score_size                        # (G,)
    score_end = bp_end + flank_score_size

    j = jnp.arange(L, dtype=jnp.int32)
    s = jnp.arange(S, dtype=jnp.int32)

    # ---- per-read kernel vectors (G, R, L)
    qual_i = jnp.clip(quals.astype(jnp.int32), 2, MAX_QSCORE)
    lnm = ln_match_lut[qual_i]
    lnx = ln_mism_lut[qual_i]
    read_n = reads == N_BASE
    pad = j[None, None, :] >= read_len[:, :, None]
    lnx_eff = jnp.where(pad, 0.0, jnp.where(read_n, LN_RANDOM, lnx))
    live = ~(read_n | pad)
    delta = jnp.where(live, lnm - lnx, 0.0)
    nadj = jnp.where(live, LN_RANDOM - lnx, 0.0)

    # K: (G, R, 5, L) -> (G, R, 5L); channel c holds delta on read==c
    ch = [delta * (reads == c) for c in _ACGT] + [nadj]
    K = jnp.stack(ch, axis=2).reshape(G, R, 5 * L)
    # hi = K rounded to bf16 in integer bit arithmetic, so the split has
    # no f32 -> bf16 -> f32 round trip: XLA may drop such a pair as
    # excess precision (the GPU backend does), which zeroes K_lo
    K_hi32 = jax.lax.bitcast_convert_type(
        (jax.lax.bitcast_convert_type(K, jnp.uint32) + jnp.uint32(0x8000))
        & jnp.uint32(0xFFFF0000), jnp.float32)
    K_hi = K_hi32.astype(jnp.bfloat16)                   # exact
    K_lo = (K - K_hi32).astype(jnp.bfloat16)

    # ---- gated target Toeplitz (G, 5, L, S) -> (G, 5L, S), bf16-exact
    p = s0[:, None, None] + j[:, None] + s[None, :]              # (G, L, S)
    p_c = jnp.clip(p, 0, T - 1)
    tg = jnp.take_along_axis(
        targets, p_c.reshape(G, L * S), axis=-1).reshape(G, L, S)
    gate = (p > score_beg[:, None, None]) & (p <= score_end[:, None, None])
    tch = [(tg == c) & gate for c in _ACGT] + [(tg == N_BASE) & gate]
    Tmat = jnp.stack(tch, axis=1).reshape(G, 5 * L, S) \
        .astype(jnp.bfloat16)

    M = jnp.einsum("grm,gms->grs", K_hi, Tmat,
                   preferred_element_type=jnp.float32) \
        + jnp.einsum("grm,gms->grs", K_lo, Tmat,
                     preferred_element_type=jnp.float32)

    # ---- base part: sum_j gate(s+j) * lnx_eff(r, j) via prefix sums
    P = jnp.concatenate(
        [jnp.zeros((G, R, 1), jnp.float32), jnp.cumsum(lnx_eff, axis=-1)],
        axis=-1)                                                 # (G, R, L+1)
    s_abs = s0[:, None] + s[None, :]                             # (G, S)
    jlo = jnp.maximum(score_beg[:, None] - s_abs + 1, 0)         # (G, S)
    jhi = jnp.minimum(score_end[:, None] - s_abs,
                      jnp.int32(L - 1))                          # (G, S)
    jhi = jnp.minimum(jhi[:, None, :], read_len[:, :, None] - 1)  # (G, R, S)
    jlo = jnp.minimum(jlo, jnp.int32(L))[:, None, :] \
        * jnp.ones((1, R, 1), jnp.int32)
    ok = jhi >= jlo
    base = jnp.where(
        ok,
        jnp.take_along_axis(P, jnp.where(ok, jhi + 1, 0), axis=-1)
        - jnp.take_along_axis(P, jnp.where(ok, jlo, 0), axis=-1),
        0.0)

    lnl = base + M                                               # (G, R, S)

    scan_start = jnp.maximum(0, bp_beg[:, None] - read_len + 2)  # (G, R)
    scan_end = jnp.maximum(
        0, jnp.minimum(bp_end[:, None], target_len[:, None] - read_len))
    s_valid = (s_abs[:, None, :] >= scan_start[:, :, None]) & \
        (s_abs[:, None, :] <= scan_end[:, :, None])
    lnl = jnp.where(s_valid, lnl, -jnp.inf)
    best_i = jnp.argmax(lnl, axis=-1).astype(jnp.int32)
    best = jnp.take_along_axis(lnl, best_i[:, :, None], axis=-1)[:, :, 0]
    any_valid = jnp.any(s_valid, axis=-1)
    pos = jnp.where(any_valid, s0[:, None] + best_i, scan_start)
    return best, pos
