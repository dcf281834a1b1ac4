"""Kernel timing on the GPU: the device paths' kernels at real shapes.

Each measurement compiles the kernel, warms it up, then times
`reps` calls, each ending in `block_until_ready`, and reports the
median (and min/max) with the card's name and power limit. A machine
whose JAX platform is not 'gpu' is refused: nothing here measures the
CPU backend.

Measured kernels (the production device paths):
  - jump_cuda / jump_xla: contig jump-score DP, the hand-written CUDA
    kernel (align/cuda_jumpscore) and XLA's lax.scan form
    (align/device_jumpscore.batched_jump_score), at the production
    shape and at the largest bucket the high-span deep run dispatches
    → Gcells/s (real, unpadded DP cells), contigs/s
  - split_exact / split_mxu: split-read scan, exact and matrix-product
    forms → Gterms/s, split scans/s
  - matmul: a bf16 matrix product, as the card's attainable anchor
    (fraction of the data-sheet peak for this device kind)

Usage: python benchmarks/device_timing.py [--kernel all] [--reps 7]
       [--json out.jsonl]
Prints one JSON line per measurement.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# Dense peak rates per device kind (NVIDIA H100 data sheet; SXM5 part
# at its 700 W limit, PCIe at 350 W, NVL at 400 W).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes_s": 3.35e12},
    "NVIDIA H100 PCIe": {"bf16_flops": 756e12, "hbm_bytes_s": 2.0e12},
    "NVIDIA H100 NVL": {"bf16_flops": 835e12, "hbm_bytes_s": 3.9e12},
}

# (B, nq_pad, nr1_pad, nr2_pad), (query, ref1, ref2) real lengths
JUMP_SHAPES = {
    "production": ((64, 512, 1024, 1024), (400, 800, 800)),
    "deep_largest": ((16, 256, 1024, 1024), (250, 1000, 1000)),
}


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def card() -> dict:
    """The JAX device and the card's name and power limit; refuses any
    platform but 'gpu'."""
    from manta_tpu.device import probe
    platform, kind, count = probe()
    if platform != "gpu":
        raise SystemExit(f"device_timing: no GPU (JAX platform "
                         f"{platform!r}); device times come from a card")
    if kind not in PEAKS:
        raise SystemExit(f"device_timing: no data-sheet peaks for {kind!r}")
    return {"platform": platform, "device_kind": kind, "count": count,
            "nvidia_smi": nvidia_smi()}


def time_call(fn, args, reps: int) -> dict:
    """Compile + warm, then `reps` timed calls ending in
    block_until_ready; seconds per call."""
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return {"median_s": statistics.median(ts), "min_s": min(ts),
            "max_s": max(ts), "reps": reps, "first_call_s": first}


def _emit(rec, dev, out):
    rec = {**rec, "device": dev}
    line = json.dumps(rec)
    print(line, flush=True)
    if out:
        out.write(line + "\n")
        out.flush()
    return rec


def jump_inputs(shape, lens, seed=0):
    """Jobs of the given real lengths, padded to `shape`: even rows
    span the junction (query from ref1's end and ref2's start, with a
    few substitutions), odd rows are random. Returns (jobs, the six
    padded kernel arrays, the number of real DP cells)."""
    B, nq, nr1, nr2 = shape
    lq, l1, l2 = lens
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    jobs = []
    for b in range(B):
        r1 = acgt[rng.integers(0, 4, l1)]
        r2 = acgt[rng.integers(0, 4, l2)]
        if b % 2 == 0:
            a = min(lq // 2, l1)
            q = np.concatenate([r1[l1 - a:], r2[:min(lq - a, l2)]])
            q[rng.integers(0, len(q), 4)] = acgt[rng.integers(0, 4, 4)]
        else:
            q = acgt[rng.integers(0, 4, lq)]
        jobs.append((q.tobytes(), r1.tobytes(), r2.tobytes()))

    def pad(seqs, n, fill):
        arr = np.full((B, n), fill, np.int32)
        for i, s in enumerate(seqs):
            arr[i, :len(s)] = np.frombuffer(s, np.uint8)
        return arr, np.array([len(s) for s in seqs], np.int32)
    arrays = (*pad([j[0] for j in jobs], nq, 1),
              *pad([j[1] for j in jobs], nr1, 2),
              *pad([j[2] for j in jobs], nr2, 2))
    cells = float(sum(len(q) * (len(r1) + len(r2)) for q, r1, r2 in jobs))
    return jobs, arrays, cells


def bench_jump(kernel, dev, out, reps) -> dict:
    """Times one jump kernel at every JUMP_SHAPES entry; returns the
    records by shape name."""
    import jax
    from manta_tpu.candidates.refiner import RefinerOptions
    if kernel == "cuda":
        from manta_tpu.align.cuda_jumpscore import cuda_jump_score as fn
    else:
        from manta_tpu.align.device_jumpscore import batched_jump_score as fn
    opt = RefinerOptions()
    sc = opt.spanning_scores
    consts = (sc.match, sc.mismatch, sc.open, sc.extend, sc.off_edge,
              opt.jump_score)
    recs = {}
    for name, (shape, lens) in JUMP_SHAPES.items():
        _jobs, args, cells = jump_inputs(shape, lens)
        args = [jax.device_put(a) for a in args]
        jitted = jax.jit(lambda *a: fn(*a, *consts, *shape[1:]))
        t = time_call(jitted, args, reps)
        recs[name] = _emit({
            "kernel": f"jump_{kernel}", "shape": name,
            "padded": list(shape), "lengths": list(lens), **t,
            "gcells_per_s": cells / t["median_s"] / 1e9,
            "contigs_per_s": shape[0] / t["median_s"]}, dev, out)
    return recs


def _split_inputs(B, T, L, seed=0):
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    reads = bases[rng.integers(0, 4, (B, L))]
    quals = rng.integers(20, 40, (B, L)).astype(np.uint8)
    targets = bases[rng.integers(0, 4, (B, T))]
    bp_beg = np.full(B, T // 2 - 5, np.int32)
    bp_end = np.full(B, T // 2 + 5, np.int32)
    return (reads, quals, targets, bp_beg, bp_end,
            np.full(B, L, np.int32), np.full(B, T, np.int32))


def bench_split_exact(dev, out, reps, B=512, T=500, L=150):
    import jax
    from manta_tpu.align.device_splitscore import (batched_split_score,
                                                   make_luts)
    args = _split_inputs(B, T, L)
    lnm, lnx = make_luts(0.0)
    n_scan = int((args[4] - np.maximum(0, args[3] - args[5] + 2)).max()) + 1
    args = [jax.device_put(a) for a in args]
    fn = jax.jit(lambda *a: batched_split_score(*a, 16, lnm, lnx, n_scan))
    t = time_call(fn, args, reps)
    _emit({"kernel": "split_exact", "shape": f"B={B},T={T},L={L},S={n_scan}",
           **t, "gterms_per_s": B * n_scan * L / t["median_s"] / 1e9,
           "split_scans_per_s": B / t["median_s"]}, dev, out)


def bench_split_mxu(dev, out, reps, G=8, R=64, T=500, L=150):
    import jax
    from manta_tpu.align.device_splitscore import make_luts
    from manta_tpu.align.device_splitscore_mxu import junction_split_score
    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", np.uint8)
    bp_beg = np.full(G, T // 2 - 5, np.int32)
    bp_end = np.full(G, T // 2 + 5, np.int32)
    s0 = np.maximum(0, bp_beg - L + 2).astype(np.int32)
    target_len = np.full(G, T, np.int32)
    n_scan = int((np.minimum(bp_end, target_len - L) - s0).max()) + 1
    args = [bases[rng.integers(0, 4, (G, R, L))],
            rng.integers(20, 40, (G, R, L)).astype(np.uint8),
            bases[rng.integers(0, 4, (G, T))], s0, bp_beg, bp_end,
            np.full((G, R), L, np.int32), target_len]
    lnm, lnx = make_luts(0.0)
    args = [jax.device_put(a) for a in args]
    fn = jax.jit(lambda *a: junction_split_score(*a, 16, lnm, lnx, n_scan))
    t = time_call(fn, args, reps)
    _emit({"kernel": "split_mxu",
           "shape": f"G={G},R={R},T={T},L={L},S={n_scan}", **t,
           "gterms_per_s": G * R * n_scan * L / t["median_s"] / 1e9,
           "split_scans_per_s": G * R / t["median_s"]}, dev, out)


def bench_matmul(dev, out, reps, n=8192):
    import jax
    import jax.numpy as jnp
    x = jax.device_put(jnp.ones((n, n), jnp.bfloat16))
    fn = jax.jit(lambda a: a @ a)
    t = time_call(fn, [x], reps)
    flops = 2.0 * n ** 3
    peak = PEAKS[dev["device_kind"]]["bf16_flops"]
    _emit({"kernel": "matmul_bf16", "shape": f"{n}^3", **t,
           "tflops": flops / t["median_s"] / 1e12,
           "fraction_of_datasheet_peak": flops / t["median_s"] / peak},
          dev, out)


BENCHES = {
    "jump_cuda": lambda dev, out, reps: bench_jump("cuda", dev, out, reps),
    "jump_xla": lambda dev, out, reps: bench_jump("xla", dev, out, reps),
    "split_exact": bench_split_exact,
    "split_mxu": bench_split_mxu,
    "matmul": bench_matmul,
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", default="all",
                    choices=["all"] + sorted(BENCHES))
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--json", default=None,
                    help="append JSON lines to this file")
    args = ap.parse_args()
    dev = card()
    out = open(args.json, "a") if args.json else None
    names = list(BENCHES) if args.kernel == "all" else [args.kernel]
    for name in names:
        BENCHES[name](dev, out, args.reps)


if __name__ == "__main__":
    main()
