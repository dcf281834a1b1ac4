"""Phase-2 wall of the high-span deep run under each GPU jump kernel.

Generates the high-span stress workload (stress tiles at
depth_frac=0.2 with SA evidence stripped: pair-only junctions whose
phase-2 cost concentrates in jump-contig scoring), then runs it through
run_workflow at -j 1 with --device-scoring jump, in one process on one
card, with the contig jump kernel alternating in the given order
(default CUDA, XLA, XLA, CUDA). Every run's VCFs must be identical.
Prints one JSON line per run (phase-2 wall, device dispatch totals)
and a summary line, each with the card's name and power limit.

Usage: python benchmarks/bench_jump_e2e.py [--tiles 1024]
           [--order cuda,xla,xla,cuda] [--json out.jsonl]
"""

from __future__ import annotations

import argparse
import datetime
import glob
import gzip
import json
import os
import re
import shutil
import statistics
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "benchmarks")]


def phase2_wall(run_dir) -> float:
    with open(os.path.join(run_dir, "workspace", "workflow_log.txt")) as f:
        text = f.read()

    def stamp(pattern):
        m = re.search(rf"\[([0-9T:.-]+)\] {pattern}", text)
        return datetime.datetime.fromisoformat(m.group(1))
    return (stamp(r"processed \d+ graph edges")
            - stamp("generating and scoring SV candidates")).total_seconds()


def vcfs(run_dir) -> dict:
    out = {}
    for p in sorted(glob.glob(os.path.join(run_dir, "results", "variants",
                                           "*.vcf.gz"))):
        with gzip.open(p, "rb") as f:
            out[os.path.basename(p)] = f.read()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiles", type=int, default=1024)
    ap.add_argument("--order", default="cuda,xla,xla,cuda")
    ap.add_argument("--work", default=os.path.join(REPO, ".chip_smoke"))
    ap.add_argument("--json", default=None)
    args = ap.parse_args()

    from device_timing import card
    import stress_workload as sw
    from manta_tpu import device
    from manta_tpu.align import device_jumpscore as dj
    from manta_tpu.workflow.run import run_workflow

    dev = card()
    os.makedirs(args.work, exist_ok=True)
    bam, fa, reads = sw.generate(args.tiles,
                                 os.path.join(args.work, "hspan_ab"),
                                 depth_frac=0.2, strip_sa=True)
    kernel_for = device.jump_kernel_for
    out = open(args.json, "a") if args.json else None
    walls: dict = {}
    first = None
    for i, kernel in enumerate(args.order.split(",")):
        # the scorer asks the router for its kernel when it is built
        device.jump_kernel_for = lambda _platform, k=kernel: k
        run_dir = os.path.join(args.work, f"ab_{i}_{kernel}")
        shutil.rmtree(run_dir, ignore_errors=True)
        s0 = dict(dj.DISPATCH_STATS)
        run_workflow([], [bam], fa, run_dir, is_exome=True, n_jobs=1,
                     verbose=False, use_device_scoring="jump",
                     cmdline="bench_jump_e2e")
        wall = phase2_wall(run_dir)
        walls.setdefault(kernel, []).append(wall)
        got = vcfs(run_dir)
        if first is None:
            first = got
        elif got != first:
            raise AssertionError(f"run {i} ({kernel}): VCFs differ")
        rec = {"run": i, "kernel": kernel, "tiles": args.tiles,
               "reads": reads, "phase2_wall_s": wall,
               "dispatch_calls": dj.DISPATCH_STATS["calls"] - s0["calls"],
               "dispatch_jobs": dj.DISPATCH_STATS["jobs"] - s0["jobs"],
               "dispatch_wall_s": dj.DISPATCH_STATS["wall"] - s0["wall"],
               "device": dev}
        print(json.dumps(rec), flush=True)
        if out:
            out.write(json.dumps(rec) + "\n")
        shutil.rmtree(run_dir, ignore_errors=True)
    device.jump_kernel_for = kernel_for
    summary = {"summary": "phase2_wall_s median per kernel",
               **{k: statistics.median(v) for k, v in walls.items()},
               "vcfs_identical": True, "device": dev}
    print(json.dumps(summary), flush=True)
    if out:
        out.write(json.dumps(summary) + "\n")
    for p in glob.glob(os.path.join(args.work, "hspan_ab.*")):
        os.remove(p)


if __name__ == "__main__":
    main()
