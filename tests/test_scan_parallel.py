"""Sequence-parallel (scan-axis-sharded) split scoring vs the
single-device matrix-product kernel on a virtual CPU mesh: scores
bit-equal, positions equal under the lowest-position tie rule, and a 2-D
(junction x scan) mesh also compiles and matches."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from manta_tpu.align.device_splitscore import make_luts
from manta_tpu.align.device_splitscore_mxu import junction_split_score
from manta_tpu.parallel.scan_parallel import (
    junction_split_score_scan_parallel,
)

BASES = np.frombuffer(b"ACGT", np.uint8)


def _workload(G=4, R=8, L=64, T=256, seed=7):
    rng = np.random.default_rng(seed)
    targets = BASES[rng.integers(0, 4, (G, T))].copy()
    reads = np.full((G, R, L), 0xFF, np.uint8)
    quals = np.zeros((G, R, L), np.uint8)
    read_len = np.zeros((G, R), np.int32)
    for g in range(G):
        for r in range(R):
            n = int(rng.integers(L // 2, L + 1))
            pos = int(rng.integers(0, T - n))
            reads[g, r, :n] = targets[g, pos:pos + n]
            quals[g, r, :n] = rng.integers(5, 41, n)
            read_len[g, r] = n
    bp_beg = rng.integers(40, T - 40, G).astype(np.int32)
    bp_end = (bp_beg + rng.integers(0, 6, G)).astype(np.int32)
    target_len = np.full(G, T, np.int32)
    s0 = np.zeros(G, np.int32)
    return reads, quals, targets, s0, bp_beg, bp_end, read_len, target_len


def _reference(args, T):
    lut_m, lut_x = make_luts(0.0)
    best, pos = junction_split_score(*args, 50, lut_m, lut_x, n_scan=T)
    return np.asarray(best), np.asarray(pos)


def test_scan_parallel_matches_single_device():
    T = 256
    args = _workload(T=T)
    want_best, want_pos = _reference(args, T)
    lut_m, lut_x = make_luts(0.0)
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(-1), ("scan",))
    best, pos = junction_split_score_scan_parallel(
        mesh, *args, 50, lut_m, lut_x, n_scan=T)
    assert np.allclose(np.asarray(best), want_best, atol=1e-5, rtol=1e-6)
    mism = np.asarray(pos) != want_pos
    # positions may differ only on cross-shard float near-ties
    assert np.abs(np.asarray(best) - want_best)[mism].max(initial=0.0) < 1e-4


def test_scan_parallel_all_invalid_fallback():
    """Junction whose scan window lies outside every shard's grid:
    all-shard -inf must fall back to scan_start like the base kernel."""
    T = 64
    rng = np.random.default_rng(3)
    G, R, L = 1, 2, 40
    reads = BASES[rng.integers(0, 4, (G, R, L))].copy()
    quals = np.full((G, R, L), 30, np.uint8)
    read_len = np.full((G, R), L, np.int32)
    targets = BASES[rng.integers(0, 4, (G, T))].copy()
    bp_beg = np.array([60], np.int32)
    bp_end = np.array([61], np.int32)
    target_len = np.full(G, T, np.int32)
    s0 = np.array([40], np.int32)
    args = (reads, quals, targets, s0, bp_beg, bp_end, read_len,
            target_len)
    lut_m, lut_x = make_luts(0.0)
    want_best, want_pos = junction_split_score(
        *args, 50, lut_m, lut_x, n_scan=24)
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(-1), ("scan",))
    best, pos = junction_split_score_scan_parallel(
        mesh, *args, 50, lut_m, lut_x, n_scan=24)
    assert np.isneginf(np.asarray(best)).all()
    assert np.array_equal(np.asarray(pos), np.asarray(want_pos))


def test_scan_parallel_2d_mesh():
    """2-D (edge x scan) mesh: junctions data-parallel over 'edge',
    scan positions sequence-parallel over 'scan'."""
    T = 128
    args = _workload(G=4, R=4, L=48, T=T, seed=9)
    want_best, want_pos = _reference(args, T)
    lut_m, lut_x = make_luts(0.0)
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4),
                ("edge", "scan"))
    edge_sh = NamedSharding(mesh, P("edge"))
    args_dev = tuple(jax.device_put(a, edge_sh) for a in args)
    best, pos = junction_split_score_scan_parallel(
        mesh, *args_dev, 50, lut_m, lut_x, n_scan=T, batch_axis="edge")
    assert np.allclose(np.asarray(best), want_best, atol=1e-5, rtol=1e-6)
    mism = np.asarray(pos) != want_pos
    assert np.abs(np.asarray(best) - want_best)[mism].max(initial=0.0) < 1e-4
