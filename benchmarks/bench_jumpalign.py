"""Contig jump-alignment throughput: device kernel vs host DP.

Measures the 'candidate contigs aligned/s' north-star metric
(SURVEY.md section 6): batched two-reference jump-alignment scoring
(reference: GlobalJumpAligner.hpp:36) of assembled contigs against a
pair of breakend reference windows.

- device: the GPU's production jump kernel (align/cuda_jumpscore, one
  warp per contig), median of block_until_ready-timed batch calls;
  exact int32 score parity with the host DP. Refuses a machine whose
  JAX platform is not 'gpu'.
- host:   the production native C++ aligner (with backtrace, as used
  by the refiner), one contig at a time.

Prints one JSON line per configuration.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def make_inputs(rng, B, Lq, Lr):
    bases = np.frombuffer(b"ACGT", np.uint8)
    ref1 = ["".join(map(chr, bases[rng.integers(0, 4, Lr)]))
            for _ in range(B)]
    ref2 = ["".join(map(chr, bases[rng.integers(0, 4, Lr)]))
            for _ in range(B)]
    queries = []
    for b in range(B):
        # contig straddles the junction: prefix from ref1, suffix ref2
        k = int(rng.integers(Lq // 4, 3 * Lq // 4))
        p1 = int(rng.integers(0, Lr - k))
        p2 = int(rng.integers(0, Lr - (Lq - k)))
        queries.append(ref1[b][p1:p1 + k] + ref2[b][p2:p2 + Lq - k])
    return queries, ref1, ref2


def main():
    import jax

    from manta_tpu.align.aligners import AlignmentScores, GlobalJumpAligner

    sc = AlignmentScores(1, -9, -19, -1, -1)  # refiner spanning scores
    jump = -100
    rng = np.random.default_rng(0)
    B, Lq, Lr = 512, 200, 700
    queries, ref1, ref2 = make_inputs(rng, B, Lq, Lr)

    # host: production path (score + backtrace)
    host_aligner = GlobalJumpAligner(sc, jump)
    n_host = 32  # sample; extrapolate
    t0 = time.perf_counter()
    host_res = [host_aligner.align(queries[i].encode(), ref1[i].encode(),
                                   ref2[i].encode())
                for i in range(n_host)]
    host_dt = (time.perf_counter() - t0) / n_host

    # device: the CUDA kernel on the card, median of timed batch calls
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from device_timing import card, time_call

    from manta_tpu.align.cuda_jumpscore import cuda_jump_score

    dev_info = card()
    qb = [q.encode() for q in queries]
    r1b = [r.encode() for r in ref1]
    r2b = [r.encode() for r in ref2]

    def pad_to(seqs, n, fill):
        out = np.full((B, n), fill, np.int32)
        lens = np.zeros(B, np.int32)
        for i, s in enumerate(seqs):
            arr = np.frombuffer(s, np.uint8).astype(np.int32)
            out[i, :len(arr)] = arr
            lens[i] = len(arr)
        return out, lens

    q, ql = pad_to(qb, Lq, 1)
    r1a, r1l = pad_to(r1b, Lr, 2)
    r2a, r2l = pad_to(r2b, Lr, 2)
    staged = [jax.device_put(a) for a in (q, ql, r1a, r1l, r2a, r2l)]
    fn = jax.jit(lambda *a: cuda_jump_score(
        *a, sc.match, sc.mismatch, sc.open, sc.extend, sc.off_edge, jump,
        Lq, Lr, Lr))
    dev_dt = time_call(fn, staged, reps=7)["median_s"] / B
    dev = np.asarray(fn(*staged))
    assert all(int(dev[i]) == host_res[i].score
               for i in range(n_host)), "device/host score mismatch"

    cells = Lq * 2 * Lr
    for name, dt in (("host", host_dt), ("device", dev_dt)):
        print(json.dumps({
            "metric": f"jump_align_throughput_{name}",
            "contigs_per_s": round(1.0 / dt, 1),
            "gcells_per_s": round(cells / dt / 1e9, 2),
            "batch": B if name == "device" else 1,
            "device": dev_info if name == "device" else "host CPU core",
        }))


if __name__ == "__main__":
    main()
