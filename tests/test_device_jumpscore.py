"""Device batched jump-SWG scores vs the native aligner (exact)."""

import numpy as np
import pytest

from manta_tpu.align.aligners import AlignmentScores, GlobalJumpAligner
from manta_tpu.align.device_jumpscore import jump_scores

SCORES = AlignmentScores(2, -8, -12, -1, -1)
JUMP = -100


def _rand_seq(rng, n):
    return rng.choice(list(b"ACGT"), n).astype(np.uint8).tobytes()


def test_device_jump_scores_match_native():
    rng = np.random.default_rng(11)
    aln = GlobalJumpAligner(SCORES, JUMP)
    queries, ref1s, ref2s, want = [], [], [], []
    for case in range(24):
        nr1 = int(rng.integers(30, 200))
        nr2 = int(rng.integers(30, 200))
        r1 = bytearray(_rand_seq(rng, nr1))
        r2 = bytearray(_rand_seq(rng, nr2))
        # half the cases: plant a spanning query (prefix from r1 end,
        # suffix from r2 start) with mutations
        if case % 2 == 0:
            a = int(rng.integers(10, min(60, nr1)))
            b = int(rng.integers(10, min(60, nr2)))
            q = bytearray(bytes(r1[-a:]) + bytes(r2[:b]))
            for _ in range(int(rng.integers(0, 4))):
                q[int(rng.integers(0, len(q)))] = \
                    int(rng.choice(list(b"ACGT")))
        else:
            q = bytearray(_rand_seq(rng, int(rng.integers(20, 120))))
        res = aln.align(bytes(q), bytes(r1), bytes(r2), seqmatch=False)
        queries.append(bytes(q))
        ref1s.append(bytes(r1))
        ref2s.append(bytes(r2))
        want.append(res.score)
    got = jump_scores(queries, ref1s, ref2s, SCORES, JUMP)
    np.testing.assert_array_equal(got, np.array(want, np.int32))


def test_device_jump_scores_small_jump_penalty():
    rng = np.random.default_rng(3)
    aln = GlobalJumpAligner(SCORES, -10)
    queries, ref1s, ref2s, want = [], [], [], []
    for _ in range(12):
        r1 = _rand_seq(rng, int(rng.integers(40, 120)))
        r2 = _rand_seq(rng, int(rng.integers(40, 120)))
        q = r1[-20:] + r2[:25]
        res = aln.align(q, r1, r2, seqmatch=False)
        queries.append(q)
        ref1s.append(r1)
        ref2s.append(r2)
        want.append(res.score)
    got = jump_scores(queries, ref1s, ref2s, SCORES, -10)
    np.testing.assert_array_equal(got, np.array(want, np.int32))


@pytest.mark.parametrize("jump", [JUMP, -10])
def test_native_score_batch_matches_full_aligner(jump):
    """The host score-only batch (mt_align_jump_score_batch) must give
    the full traceback aligner's scores exactly — winner selection on
    these scores is then provably identical to aligning everything.
    A cheap jump (-10) exercises the in-column insert chain after a
    jump, which GCC's -O3 vectorizer once miscompiled."""
    from manta_tpu.align.aligners import jump_score_batch
    rng = np.random.default_rng(23)
    aln = GlobalJumpAligner(SCORES, jump)
    jobs, want = [], []
    for case in range(40):
        nr1 = int(rng.integers(25, 300))
        nr2 = int(rng.integers(25, 300))
        r1 = bytearray(_rand_seq(rng, nr1))
        r2 = bytearray(_rand_seq(rng, nr2))
        if case % 2 == 0:
            a = int(rng.integers(10, min(80, nr1)))
            b = int(rng.integers(10, min(80, nr2)))
            q = bytearray(bytes(r1[-a:]) +
                          _rand_seq(rng, int(rng.integers(0, 9))) +
                          bytes(r2[:b]))
            for _ in range(int(rng.integers(0, 5))):
                q[int(rng.integers(0, len(q)))] = \
                    int(rng.choice(list(b"ACGT")))
        else:
            q = bytearray(_rand_seq(rng, int(rng.integers(20, 150))))
        res = aln.align(bytes(q), bytes(r1), bytes(r2), seqmatch=False)
        jobs.append((bytes(q), bytes(r1), bytes(r2)))
        want.append(res.score)
    got = jump_score_batch(jobs, SCORES, jump)
    assert got.tolist() == want


def test_bucketed_device_scorer_matches_full_aligner():
    """The production device backend (make_bucketed_scorer) must give
    exact scores through its shape padding."""
    from manta_tpu.align.device_jumpscore import make_bucketed_scorer
    rng = np.random.default_rng(31)
    aln = GlobalJumpAligner(SCORES, JUMP)
    scorer = make_bucketed_scorer(SCORES, JUMP)
    jobs, want = [], []
    for case in range(9):
        r1 = _rand_seq(rng, int(rng.integers(30, 120)))
        r2 = _rand_seq(rng, int(rng.integers(30, 120)))
        q = (r1[-20:] + r2[:25]) if case % 2 == 0 else \
            _rand_seq(rng, int(rng.integers(20, 90)))
        res = aln.align(q, r1, r2, seqmatch=False)
        jobs.append((q, r1, r2))
        want.append(res.score)
    got = scorer(jobs)
    assert got.tolist() == want
