"""The CUDA jump-score kernel's schedule, wrapper and build plumbing.

The kernel itself (native/jump_score.cu) runs only on the GPU and has
no interpret mode; tests that need the card carry the `gpu` marker
(test_gpu_hardware.py). Here a numpy model of one warp replays the
kernel's exact schedule (wavefront over lanes, K-row stripes, band
hand-off through the scratch rows, the ref1 -> ref2 switch) against
the native host scorer, so a change to the schedule can be checked
without a card.
"""

import numpy as np
import pytest

from manta_tpu.align.aligners import AlignmentScores, jump_score_batch
from manta_tpu.align.cuda_jumpscore import rows_per_lane, scratch_shape

SCORES = AlignmentScores(2, -8, -12, -1, -1)
BAD, NEG = -10000, -(1 << 28)


def _warp_model(q, r1, r2, sc, jump, K):
    """One warp of jump_score_kernel<K> scoring one job, lanes as a
    numpy axis; mirrors the .cu statement by statement."""
    nq, nr1 = len(q), len(r1)
    ref = np.frombuffer(r1 + r2, np.uint8).astype(np.int64)
    qa = np.frombuffer(q, np.uint8).astype(np.int64)
    ncols = len(ref)
    H = 32 * K
    lane = np.arange(32)
    off, op, ext = sc.off_edge, sc.open, sc.extend
    best = NEG
    n_bands = -(-nq // H)
    bounds = np.zeros((2, ncols, 4), np.int64)
    mx = np.maximum
    for band in range(n_bands):
        r0 = band * H + lane * K
        rows = r0[:, None] + 1 + np.arange(K)[None, :]
        qc = np.where(rows <= nq, qa[np.clip(rows, 1, nq) - 1], -1)
        pm = rows * off
        pd = np.full_like(pm, BAD)
        pi = np.full_like(pm, BAD)
        pj = np.full_like(pm, BAD)
        u = np.array([[0] * 32, [BAD] * 32, [BAD] * 32, [BAD] * 32])
        o = u.copy()
        for step in range(ncols + 31):
            c = step - lane
            r = np.concatenate([o[:, :1], o[:, :-1]], axis=1)  # shfl_up
            if band == 0:
                r[:, 0] = (0, BAD, BAD, BAD)
            elif c[0] < ncols:
                r[:, 0] = bounds[band & 1, c[0]]
            d = u.copy()
            u = r
            act = (c >= 0) & (c < ncols)
            cc = np.clip(c, 0, ncols - 1)
            is1 = cc < nr1
            start = act & ((c == 0) | (c == nr1))
            d[0] = np.where(start, r0 * off, d[0])
            d[1] = np.where(start, BAD, d[1])
            d[2] = np.where(start, BAD, d[2])
            d[3] = np.where(act & (c == 0), BAD, d[3])
            sw = (act & (c == nr1))[:, None]
            if band == 0 and sw[0, 0]:
                best = max(best, nq * off)
            best = max(best, int(np.where(
                sw & (rows < nq), pm + (nq - rows) * off, NEG).max()))
            pm = np.where(sw, rows * off, pm)
            pd = np.where(sw, BAD, pd)
            pi = np.where(sw, BAD, pi)
            rc = ref[cc]
            upm, upi, upj = u[0], u[2], u[3]
            dm, dd, di, dj = d
            for k in range(K):
                row = rows[:, k]
                sub = np.where(qc[:, k] == rc, sc.match, sc.mismatch)
                vd = mx(mx(pm[:, k] + op, pd[:, k]), pi[:, k]) + ext
                vm1 = mx(mx(dm, dd), di) + sub
                vi1 = mx(mx(upm + op, BAD), upi) + ext
                vd1 = np.where(row == 1, BAD, vd)
                vi1 = np.where(row == 1, BAD, vi1)
                vj1 = mx(mx(vm1 + jump, BAD), mx(vi1 + jump, pj[:, k]))
                vm2 = mx(mx(mx(dm, dd), di), dj) + sub
                vi2 = mx(mx(mx(upm + op, BAD), upi), upj) + ext
                vm = np.where(act, np.where(is1, vm1, vm2), pm[:, k])
                vd = np.where(act, np.where(is1, vd1, vd), pd[:, k])
                vi = np.where(act, np.where(is1, vi1, vi2), pi[:, k])
                vj = np.where(act, np.where(is1, vj1, pj[:, k]), pj[:, k])
                dm, dd, di, dj = (a[:, k].copy() for a in (pm, pd, pi, pj))
                pm[:, k], pd[:, k], pi[:, k], pj[:, k] = vm, vd, vi, vj
                upm, upi, upj = vm, vi, vj
                best = max(best, int(np.where(
                    act & (row == nq), vm, NEG).max()))
            last = np.stack([pm[:, -1], pd[:, -1], pi[:, -1], pj[:, -1]])
            o = np.where(act[None, :], last, o)
            if act[31] and band + 1 < n_bands:
                bounds[(band + 1) & 1, c[31]] = o[:, 31]
        if band == 0:
            best = max(best, nq * off)
        best = max(best, int(np.where(
            rows < nq, pm + (nq - rows) * off, NEG).max()))
    return best


def _jobs(seed, n, qmax, rmax):
    rng = np.random.default_rng(seed)

    def seq(k):
        return bytes(rng.choice(list(b"ACGT"), k).astype(np.uint8))
    jobs = []
    for case in range(n):
        r1 = seq(int(rng.integers(1, rmax)))
        r2 = seq(int(rng.integers(1, rmax)))
        if case % 2 == 0:
            a = int(rng.integers(0, len(r1) + 1))
            b = int(rng.integers(0, len(r2) + 1))
            q = bytearray(r1[len(r1) - a:] + seq(int(rng.integers(0, 4)))
                          + r2[:b] or seq(1))
            for _ in range(int(rng.integers(0, 3))):
                q[int(rng.integers(0, len(q)))] = \
                    int(rng.choice(list(b"ACGT")))
            q = bytes(q)
        else:
            q = seq(int(rng.integers(1, qmax)))
        jobs.append((q, r1, r2))
    return jobs


@pytest.mark.parametrize("K,jump", [(1, -100), (2, -100), (2, -10),
                                    (4, -25)])
def test_warp_schedule_matches_native(K, jump):
    """Band counts from 1 to 5 (32*K-row bands), references down to one
    base, spanning and random queries."""
    jobs = _jobs(100 + K, 10, 150, 60)
    want = jump_score_batch(jobs, SCORES, jump)
    got = [_warp_model(q, r1, r2, SCORES, jump, K) for q, r1, r2 in jobs]
    assert got == want.tolist()


@pytest.mark.parametrize("nq_pad,K", [(128, 4), (256, 8), (512, 16),
                                      (1024, 16), (8192, 16)])
def test_rows_per_lane_tiers(nq_pad, K):
    assert rows_per_lane(nq_pad) == K


@pytest.mark.parametrize("nq_pad,want", [
    (128, (1,)), (512, (1,)), (1024, (64, 2, 3072, 4)),
    (4096, (64, 2, 3072, 4))])
def test_scratch_only_for_multi_band_queries(nq_pad, want):
    assert scratch_shape(64, nq_pad, 1024, 2048) == want
