"""Phase-1 read-gate math on the device mesh (the P1 genome-bin axis).

Phase 1's per-read work — core filters, pair-orientation and
template-length gates feeding the SV-evidence decision (reference:
SVLocusSetFinder::update, SVLocusSetFinder.cpp:79-170 +
SVLocusScanner::isSVEvidence, SVLocusScanner.cpp:1437) — is pure
elementwise mask arithmetic over fixed-width read columns, i.e. an
ideal XLA kernel. The production pipeline runs it host-side (a measured
Amdahl decision: phase 1 is IO-bound on the host), but the math
itself is device-clean; this module is the jnp twin of the numpy
building blocks in core/readfilter.py, held bit-identical by
tests/test_phase1_mesh.py and executed under the multichip dryrun's
genome-bin mesh axis so the P1 sharding story is compiled and run, not
asserted.

Mapping: reads arrive position-sorted; sharding the read axis over the
mesh's "data" axis IS the genome-bin decomposition (contiguous
position ranges per device). The per-shard evidence counts reduce with
one psum — the only cross-bin coupling phase 1 has before graph merge.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..io.bam import (
    FLAG_DUP, FLAG_MATE_REVERSE, FLAG_MATE_UNMAPPED, FLAG_PAIRED,
    FLAG_QCFAIL, FLAG_REVERSE, FLAG_SECONDARY, FLAG_SUPPLEMENTARY,
    FLAG_UNMAPPED,
)


def read_gate_masks(flag, mapq, pos, next_pos, refid, next_refid, tlen,
                    sa, min_mapq: int, min_tlen: int, max_tlen: int):
    """Device twin of the phase-1 per-read gates.

    Inputs are int32/bool arrays of one shard's reads (any shape, all
    equal); `sa` marks reads carrying an SA tag. Returns
    (core_bad, innie, anomalous, candidate) bool arrays:

    - core_bad: io gate — qcfail/dup, secondary/supplementary without
      SA, unmapped (core/readfilter.is_read_unmapped_or_filtered_core)
    - innie: FR pair on one chromosome with consistent strand/position
      order (core/readfilter.is_innie_pair)
    - anomalous: mapped pair that is NOT a proper innie within the
      fragment-size window [min_tlen, max_tlen] — the pair-evidence
      trigger (reference: AlignmentPairAnalyzer via
      SVLocusScanner.cpp:547-925 sizing gates)
    - candidate: survives core gate + mapq and is anomalous — the
      shard's contribution to evidence counts
    """
    f = flag
    core_bad = (f & (FLAG_QCFAIL | FLAG_DUP)) != 0
    core_bad |= ((f & FLAG_SUPPLEMENTARY) != 0) & ~sa
    core_bad |= ((f & FLAG_SECONDARY) != 0) & ~sa
    core_bad |= (f & FLAG_UNMAPPED) != 0

    mapped_pair = ((f & FLAG_PAIRED) != 0) & \
        ((f & (FLAG_UNMAPPED | FLAG_MATE_UNMAPPED)) == 0)
    chrom_pair = mapped_pair & (refid == next_refid) & (refid >= 0)
    fwd = (f & FLAG_REVERSE) == 0
    mate_fwd = (f & FLAG_MATE_REVERSE) == 0
    innie = chrom_pair & (fwd != mate_fwd)
    left = pos < next_pos
    right = pos > next_pos
    innie &= ~(left & ~fwd)
    innie &= ~(right & fwd)

    atl = jnp.abs(tlen)
    proper = innie & (atl >= min_tlen) & (atl <= max_tlen)
    anomalous = mapped_pair & ~proper

    candidate = ~core_bad & (mapq >= min_mapq) & anomalous
    return core_bad, innie, anomalous, candidate


def shard_evidence_counts(candidate):
    """Per-shard evidence count; under jit over sharded operands XLA
    reduces this with a cross-device collective (the phase-1 analogue
    of the reference's per-segment counter merge)."""
    return jnp.sum(candidate.astype(jnp.int32))
