"""Production device-scoring router vs the native host scan: the
DeviceScanContext must return bit-identical (lnl, pos) for real demo
reads (reference: GenerateSVCandidates/SVScorerSplit.cpp split-read
realignment; routing is a pure performance choice)."""

import numpy as np
import pytest

from manta_tpu.io.bam import BamReader
from manta_tpu.scoring.evidence import QscoreSnp, split_read_scan_multi


@pytest.fixture(scope="module")
def batch(tumor_bam):
    return BamReader(tumor_bam).fetch("8", 107652000, 107655000)


def _targets_from(batch, idx):
    # junction targets: real read sequences spliced at a fake junction
    s = [batch.seq[batch.seq_off[i]:batch.seq_off[i + 1]]
         for i in idx[:2]]
    t1 = np.concatenate([s[0], s[1][:40]])
    t2 = np.concatenate([s[1], s[0][:60]])
    return [t1, t2], [(len(s[0]) - 3, len(s[0]) + 2),
                      (len(s[1]) - 4, len(s[1]) + 1)]


def test_device_scan_matches_host(batch):
    from manta_tpu.scoring.device_scan import DeviceScanContext
    qconv = QscoreSnp(1e-3)
    read_idx = np.arange(0, 96, dtype=np.int64)
    targets, bp_ranges = _targets_from(batch, read_idx)
    h_lnl, h_pos = split_read_scan_multi(
        50, batch, read_idx, qconv, targets, bp_ranges)
    ctx = DeviceScanContext()
    d_lnl, d_pos = ctx.scan_multi(
        50, batch, read_idx, qconv, targets, bp_ranges)
    assert d_lnl.shape == h_lnl.shape == (96, 2)
    # the exact kernel accumulates bases in the host scan's order
    assert np.array_equal(h_lnl, d_lnl)
    assert np.array_equal(h_pos, d_pos)


def test_device_scan_mxu_matches_host(batch):
    """The matrix-product ('mxu') production route agrees with the host scan to
    float tolerance; winner positions match except on near-ties."""
    from manta_tpu.scoring.device_scan import DeviceScanContext
    qconv = QscoreSnp(1e-3)
    read_idx = np.arange(0, 96, dtype=np.int64)
    targets, bp_ranges = _targets_from(batch, read_idx)
    h_lnl, h_pos = split_read_scan_multi(
        50, batch, read_idx, qconv, targets, bp_ranges)
    d_lnl, d_pos = DeviceScanContext(mxu=True).scan_multi(
        50, batch, read_idx, qconv, targets, bp_ranges)
    assert d_lnl.shape == h_lnl.shape == (96, 2)
    assert np.allclose(h_lnl, d_lnl, atol=1e-3, rtol=1e-4)
    mism = h_pos != d_pos
    assert np.abs(h_lnl - d_lnl)[mism].max(initial=0.0) < 1e-2
    assert (h_pos == d_pos).mean() > 0.9


def test_device_scan_mxu_iupac_fallback(batch):
    """Targets with non-ACGTN IUPAC codes route to the exact kernel."""
    from manta_tpu.scoring.device_scan import DeviceScanContext
    qconv = QscoreSnp(1e-3)
    read_idx = np.arange(0, 8, dtype=np.int64)
    targets, bp_ranges = _targets_from(batch, read_idx)
    targets[0] = targets[0].copy()
    targets[0][5] = ord("M")  # amino IUPAC code
    h_lnl, h_pos = split_read_scan_multi(
        50, batch, read_idx, qconv, targets, bp_ranges)
    ctx = DeviceScanContext(mxu=True)
    assert not ctx._mxu_eligible(np.zeros((1, 1), np.uint8) + 65, targets)
    d_lnl, d_pos = ctx.scan_multi(
        50, batch, read_idx, qconv, targets, bp_ranges)
    # the exact kernel accumulates bases in the host scan's order
    assert np.array_equal(h_lnl, d_lnl)
    assert np.array_equal(h_pos, d_pos)


def test_device_scan_tier_boundary(batch):
    """Batches whose padded shapes straddle a bucket tier still agree."""
    from manta_tpu.scoring.device_scan import DeviceScanContext
    qconv = QscoreSnp(1e-3)
    read_idx = np.arange(0, 8, dtype=np.int64)
    s = [batch.seq[batch.seq_off[i]:batch.seq_off[i + 1]]
         for i in read_idx[:4]]
    long_target = np.concatenate(s * 2)   # > 256-tier scan length
    targets = [long_target]
    bp_ranges = [(100, 110)]
    h_lnl, h_pos = split_read_scan_multi(
        50, batch, read_idx, qconv, targets, bp_ranges)
    d_lnl, d_pos = DeviceScanContext().scan_multi(
        50, batch, read_idx, qconv, targets, bp_ranges)
    # the exact kernel accumulates bases in the host scan's order
    assert np.array_equal(h_lnl, d_lnl)
    assert np.array_equal(h_pos, d_pos)
