"""Matrix-product ('mxu') split-read scorer vs the exact gather kernel.

The matrix-product formulation shares one target per junction across
all its reads; parity is checked against batched_split_score on the same
(read, target) pairs. Scores agree to ~1e-4 (bf16 hi/lo kernel split,
float32 accumulation); winner positions must agree wherever the
score landscape is not a near-tie.
"""

import numpy as np

from manta_tpu.align.device_splitscore import batched_split_score, make_luts
from manta_tpu.align.device_splitscore_mxu import junction_split_score

BASES = np.frombuffer(b"ACGT", np.uint8)


def _junction(rng, R, L, T, with_n=False):
    target = BASES[rng.integers(0, 4, T)].copy()
    if with_n:
        target[rng.integers(0, T, 5)] = ord("N")
    reads = np.full((R, L), 0xFF, np.uint8)
    quals = np.zeros((R, L), np.uint8)
    read_len = np.zeros(R, np.int32)
    for r in range(R):
        n = int(rng.integers(L // 2, L + 1))
        pos = int(rng.integers(0, T - n))
        seq = target[pos:pos + n].copy()
        for _ in range(int(rng.integers(0, 6))):
            seq[rng.integers(0, n)] = BASES[rng.integers(0, 4)]
        if with_n and rng.integers(0, 2):
            seq[rng.integers(0, n)] = ord("N")
        reads[r, :n] = seq
        quals[r, :n] = rng.integers(5, 41, n)
        read_len[r] = n
    bp_beg = int(rng.integers(60, T - 60))
    bp_end = bp_beg + int(rng.integers(0, 8))
    return reads, quals, read_len, target, bp_beg, bp_end


def _run_case(seed, with_n, G=3, R=8, L=80, T=300, s0_mode="zero"):
    rng = np.random.default_rng(seed)
    reads = np.zeros((G, R, L), np.uint8)
    quals = np.zeros((G, R, L), np.uint8)
    read_len = np.zeros((G, R), np.int32)
    targets = np.zeros((G, T), np.uint8)
    bp_beg = np.zeros(G, np.int32)
    bp_end = np.zeros(G, np.int32)
    for g in range(G):
        reads[g], quals[g], read_len[g], targets[g], bp_beg[g], bp_end[g] = \
            _junction(rng, R, L, T, with_n)
    target_len = np.full(G, T, np.int32)
    lut_m, lut_x = make_luts(0.0)

    if s0_mode == "tight":
        # offset grid covering only the per-junction scan window
        s0 = np.maximum(0, bp_beg - L + 2).astype(np.int32)
        n_scan = int((np.maximum(0, np.minimum(bp_end, T - read_len.min()))
                      - s0).max()) + 1
    else:
        s0 = np.zeros(G, np.int32)
        n_scan = T
    best_m, pos_m = junction_split_score(
        reads, quals, targets, s0, bp_beg, bp_end, read_len, target_len,
        50, lut_m, lut_x, n_scan=n_scan)
    best_m = np.asarray(best_m)
    pos_m = np.asarray(pos_m)

    # exact kernel on the flattened (read, target) pairs
    B = G * R
    fr = reads.reshape(B, L)
    fq = quals.reshape(B, L)
    ft = np.repeat(targets, R, axis=0)
    fb = np.repeat(bp_beg, R)
    fe = np.repeat(bp_end, R)
    fl = read_len.reshape(B)
    ftl = np.repeat(target_len, R)
    best_e, pos_e = batched_split_score(
        fr, fq, ft, fb, fe, fl, ftl, 50, lut_m, lut_x, n_scan=T)
    best_e = np.asarray(best_e).reshape(G, R)
    pos_e = np.asarray(pos_e).reshape(G, R)

    assert np.allclose(best_m, best_e, rtol=1e-4, atol=1e-4), \
        np.abs(best_m - best_e).max()
    # positions must agree except on float near-ties
    mism = pos_m != pos_e
    assert (np.abs(best_m - best_e)[mism] < 1e-3).all()
    # well-separated winners (planted reads) must agree exactly
    assert (pos_m == pos_e).mean() > 0.9


def test_mxu_matches_exact():
    _run_case(seed=11, with_n=False)


def test_mxu_matches_exact_with_n_bases():
    _run_case(seed=12, with_n=True)


def test_mxu_offset_grid():
    _run_case(seed=13, with_n=False, s0_mode="tight")


def test_mxu_no_valid_scan_position():
    # bp range beyond what any read can scan -> all -inf, pos=scan_start
    lut_m, lut_x = make_luts(0.0)
    G, R, L, T = 1, 2, 40, 60
    rng = np.random.default_rng(3)
    reads = BASES[rng.integers(0, 4, (G, R, L))].copy()
    quals = np.full((G, R, L), 30, np.uint8)
    read_len = np.full((G, R), L, np.int32)
    targets = BASES[rng.integers(0, 4, (G, T))].copy()
    bp_beg = np.array([55], np.int32)   # scan_end = min(55, 60-40)=20
    bp_end = np.array([56], np.int32)
    target_len = np.full(G, T, np.int32)
    s0 = np.array([40], np.int32)       # grid [40, 60): beyond scan_end
    best, pos = junction_split_score(
        reads, quals, targets, s0, bp_beg, bp_end, read_len, target_len,
        50, lut_m, lut_x, n_scan=20)
    assert np.isneginf(np.asarray(best)).all()
    assert (np.asarray(pos) == 17).all()  # scan_start = 55 - 40 + 2
