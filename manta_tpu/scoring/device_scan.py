"""Device routing for production split-read scoring.

Batches one breakend's candidate reads x junction targets into the
jitted XLA scan kernel (align/device_splitscore.batched_split_score).
The kernel's float32 accumulation order matches the native host scan
exactly (gated terms contribute +0.0f), so device and host paths give
bit-identical winners; routing is therefore a pure performance choice.

Two device formulations:
- exact (default): masked gather + elementwise reduction (VPU work),
  bit-identical to the host scan.
- mxu: the matmul/Toeplitz factorization
  (align/device_splitscore_mxu.junction_split_score) that shares each
  junction target across all its reads and puts the O(R*S*L) term
  evaluation on matrix products with explicit bf16 operands and float32
  accumulation. ~1e-6 relative score error (bf16 hi/lo kernel split);
  batches containing IUPAC codes outside {A,C,G,T,N} fall back to the
  exact kernel.

Shapes are bucketed (read length and scan length padded to fixed
tiers) so a handful of compiled programs serve every junction.
Enabled with run_workflow(use_device_scoring=True|"exact"|"mxu") /
--device-scoring [exact|mxu]; requires an available JAX device.
"""

from __future__ import annotations

import numpy as np

_TIERS = (256, 512, 1024, 2048, 4096, 8192)

_ACGTN_PAD = frozenset((65, 67, 71, 84, 78, 0xFF))  # A C G T N pad


def _bucket(n: int) -> int:
    for t in _TIERS:
        if n <= t:
            return t
    return ((n + 8191) // 8192) * 8192


class DeviceScanContext:
    """Holds jnp LUTs per qscore converter and dispatches bucketed
    batches to the jitted kernel."""

    def __init__(self, mxu: bool = False):
        import jax  # noqa: F401  (fail early if unavailable)
        self._mxu = bool(mxu)
        self._luts = {}

    def _luts_for(self, qconv):
        hit = self._luts.get(id(qconv))
        if hit is None:
            import jax.numpy as jnp
            m, x = qconv.lut256()
            # kernel clamps quals to [2, 70] and indexes a 71-entry LUT;
            # reuse the first 71 entries of the 256-entry byte LUTs
            hit = (jnp.asarray(m[:71]), jnp.asarray(x[:71]), qconv)
            self._luts[id(qconv)] = hit
        return hit[0], hit[1]

    def scan_multi(self, flank_score_size, batch, read_idx, qconv,
                   targets, bp_ranges):
        """Same contract as evidence.split_read_scan_multi."""
        n = len(read_idx)
        read_lens = (batch.seq_off[read_idx + 1]
                     - batch.seq_off[read_idx]).astype(np.int32)
        Lp = _bucket(int(read_lens.max()))
        Tp = _bucket(max(len(tg) for tg in targets) + 1)

        reads = np.full((n, Lp), 0xFF, np.uint8)
        quals = np.zeros((n, Lp), np.uint8)
        for r in range(n):
            i = int(read_idx[r])
            s0, s1 = int(batch.seq_off[i]), int(batch.seq_off[i + 1])
            q0, q1 = int(batch.qual_off[i]), int(batch.qual_off[i + 1])
            reads[r, :s1 - s0] = batch.seq[s0:s1]
            quals[r, :q1 - q0] = batch.qual[q0:q1]

        if self._mxu:
            if self._mxu_eligible(reads, targets):
                return self._scan_mxu(flank_score_size, reads, quals,
                                      read_lens, qconv, targets,
                                      bp_ranges, Tp)
            # IUPAC codes the one-hot factorization can't encode fall
            # back to the exact kernel (LUT-driven, any byte)
        return self._scan_exact(flank_score_size, reads, quals, read_lens,
                                qconv, targets, bp_ranges, Tp)

    @staticmethod
    def _mxu_eligible(reads, targets) -> bool:
        codes = set(np.unique(reads).tolist())
        for tg in targets:
            codes.update(np.unique(tg).tolist())
        return codes <= _ACGTN_PAD

    def _scan_exact(self, flank_score_size, reads, quals, read_lens,
                    qconv, targets, bp_ranges, Tp):
        import jax
        from ..align.device_splitscore import batched_split_score

        n, Lp = reads.shape
        t = len(targets)
        B = n * t
        # replicate each read row across its t junction targets
        freads = np.repeat(reads, t, axis=0)
        fquals = np.repeat(quals, t, axis=0)
        tgts = np.full((B, Tp), ord("N"), np.uint8)
        bp_beg = np.zeros(B, np.int32)
        bp_end = np.zeros(B, np.int32)
        tl = np.zeros(B, np.int32)
        for k, tg in enumerate(targets):
            tgts[k::t, :len(tg)] = tg
            bp_beg[k::t] = bp_ranges[k][0]
            bp_end[k::t] = bp_ranges[k][1]
            tl[k::t] = len(tg)
        rl = np.repeat(read_lens, t)
        lut_m, lut_x = self._luts_for(qconv)
        best, pos = batched_split_score(
            freads, fquals, tgts, bp_beg, bp_end, rl, tl,
            flank_score_size, lut_m, lut_x, n_scan=Tp)
        best = np.asarray(jax.device_get(best))
        pos = np.asarray(jax.device_get(pos))
        return (best.reshape(n, t).astype(np.float32),
                pos.reshape(n, t).astype(np.int32))

    def _scan_mxu(self, flank_score_size, reads, quals, read_lens,
                  qconv, targets, bp_ranges, Tp):
        import jax
        from ..align.device_splitscore_mxu import junction_split_score

        n, Lp = reads.shape
        t = len(targets)
        # one matmul group per target; every group scores the same reads
        greads = np.broadcast_to(reads, (t, n, Lp)).copy()
        gquals = np.broadcast_to(quals, (t, n, Lp)).copy()
        grl = np.broadcast_to(read_lens, (t, n)).copy()
        tgts = np.full((t, Tp), ord("N"), np.uint8)
        bp_beg = np.zeros(t, np.int32)
        bp_end = np.zeros(t, np.int32)
        tl = np.zeros(t, np.int32)
        for k, tg in enumerate(targets):
            tgts[k, :len(tg)] = tg
            bp_beg[k] = bp_ranges[k][0]
            bp_end[k] = bp_ranges[k][1]
            tl[k] = len(tg)
        s0 = np.zeros(t, np.int32)
        lut_m, lut_x = self._luts_for(qconv)
        best, pos = junction_split_score(
            greads, gquals, tgts, s0, bp_beg, bp_end, grl, tl,
            flank_score_size, lut_m, lut_x, n_scan=Tp)
        best = np.asarray(jax.device_get(best))   # (t, n)
        pos = np.asarray(jax.device_get(pos))
        return (best.T.astype(np.float32).copy(),
                pos.T.astype(np.int32).copy())
