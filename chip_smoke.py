#!/usr/bin/env python3
"""Smoke run of the system's device path on one NVIDIA GPU.

    python chip_smoke.py

Phases, all in this one process, which is the only one that opens the
card (the host-only comparison run is a child that never imports JAX):

1. device: JAX's platform, device kind and count, and the card's name
   and power limit from nvidia-smi; fails unless the platform is 'gpu'.
2. kernels: compiles the CUDA jump-score kernel at the production
   shape, the largest shape the deep run emits and a query tall enough
   for several bands; checks it against the native host scorer (exact
   int32, 16 rows) and XLA's batched_jump_score (all rows); checks the
   exact and matrix-product split-read scans against the host scan.
3. demo: the tumor/normal demo through run_workflow with contig jump
   scoring on the card ('jump', then 'exact'); the somatic VCF body
   must equal tests/data/demo/expectedResults/somaticSV.vcf.gz.
4. deep: the high-span stress workload (1024 tiles, ~2.3 M reads),
   host-only and with 'jump', both at -j 1; every output VCF must be
   byte-identical, and the device must have scored jobs.

The last line of standard output, printed only when every phase
passed, is {"ok": true, "device": {"platform", "kind", "count"}}. Any
failure exits non-zero without it.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import shutil
import subprocess
import sys
import time
from types import SimpleNamespace

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".chip_smoke")
DEMO = os.path.join(REPO, "tests", "data", "demo")
DEEP_TILES = 1024
RUN_CMDLINE = "chip_smoke"

# (B, nq_pad, nr1_pad, nr2_pad) and the real lengths inside them
KERNEL_SHAPES = {
    # production: 64 contigs of 400 bases against 2 x 800-base windows
    "production": ((64, 512, 1024, 1024), (400, 800, 800)),
    # the largest bucket the deep run dispatches
    "deep_largest": ((16, 256, 1024, 1024), (250, 1000, 1000)),
    # a query taller than one 512-row band, refs past the 4096 tier
    "tall": ((8, 8192, 8192, 8192), (5000, 4500, 4500)),
}


def log(msg):
    print(msg, flush=True)


def phase_device():
    from device_timing import nvidia_smi
    from manta_tpu.device import probe
    platform, kind, count = probe()
    log(f"[device] platform={platform} kind={kind} count={count}")
    if platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX platform {platform!r})")
    card = nvidia_smi()
    log(f"[device] nvidia-smi: {card}")
    return {"platform": platform, "kind": kind, "count": count}, card


def phase_kernels():
    import jax
    import numpy as np
    from device_timing import jump_inputs
    from manta_tpu.align.aligners import jump_score_batch
    from manta_tpu.align.cuda_jumpscore import cuda_jump_score
    from manta_tpu.align.device_jumpscore import batched_jump_score
    from manta_tpu.candidates.refiner import RefinerOptions

    opt = RefinerOptions()
    sc = opt.spanning_scores
    consts = (sc.match, sc.mismatch, sc.open, sc.extend, sc.off_edge,
              opt.jump_score)
    for name, (shape, lens) in KERNEL_SHAPES.items():
        jobs, args, _cells = jump_inputs(shape, lens, seed=len(name))
        args = [jax.device_put(a) for a in args]
        pads = shape[1:]
        results = {}
        for kname, fn in (("cuda", cuda_jump_score),
                          ("xla", batched_jump_score)):
            jitted = jax.jit(
                lambda *a, fn=fn: fn(*a, *consts, *pads))
            t0 = time.perf_counter()
            compiled = jitted.lower(*args).compile()
            ct = time.perf_counter() - t0
            log(f"[kernels] {name} {shape} {kname}: compiled in "
                f"{ct:.2f}s; memory_analysis: "
                f"{compiled.memory_analysis()}")
            results[kname] = np.asarray(compiled(*args))
        want = jump_score_batch(jobs[:16], sc, opt.jump_score)
        if not np.array_equal(results["cuda"][:16], want):
            raise AssertionError(f"{name}: CUDA kernel != native scorer")
        if not np.array_equal(results["cuda"], results["xla"]):
            raise AssertionError(f"{name}: CUDA kernel != XLA form")
        log(f"[kernels] {name}: CUDA == native (16 rows) == XLA "
            f"({shape[0]} rows)")
    _check_split_scans()


def _check_split_scans(n_reads=256, T=500, L=150):
    """Production split-scan routes vs the host scan at B = 512
    (read, target) rows."""
    import numpy as np
    from manta_tpu.scoring.device_scan import DeviceScanContext
    from manta_tpu.scoring.evidence import QscoreSnp, split_read_scan_multi

    rng = np.random.default_rng(5)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    targets = [acgt[rng.integers(0, 4, T)] for _ in range(2)]
    seqs, quals = [], []
    for r in range(n_reads):
        tg = targets[r % 2]
        p = int(rng.integers(0, T - L))
        s = tg[p:p + L].copy()
        s[rng.integers(0, L, 3)] = acgt[rng.integers(0, 4, 3)]
        seqs.append(s)
        quals.append(rng.integers(10, 40, L).astype(np.uint8))
    off = np.arange(n_reads + 1, dtype=np.int64) * L
    batch = SimpleNamespace(seq=np.concatenate(seqs), seq_off=off,
                            qual=np.concatenate(quals), qual_off=off)
    bp_ranges = [(240, 245), (250, 252)]
    qconv = QscoreSnp(1e-3)
    idx = np.arange(n_reads, dtype=np.int64)
    h_lnl, h_pos = split_read_scan_multi(50, batch, idx, qconv, targets,
                                         bp_ranges)
    e_lnl, e_pos = DeviceScanContext().scan_multi(
        50, batch, idx, qconv, targets, bp_ranges)
    if not (np.array_equal(h_lnl, e_lnl) and np.array_equal(h_pos, e_pos)):
        raise AssertionError("exact split scan differs from the host scan")
    m_lnl, m_pos = DeviceScanContext(mxu=True).scan_multi(
        50, batch, idx, qconv, targets, bp_ranges)
    err = np.abs(m_lnl - h_lnl)
    rel = err / np.maximum(np.abs(h_lnl), 1e-30)
    moved = m_pos != h_pos
    log(f"[kernels] split scans at B={2 * n_reads}, T={T}, L={L}: exact "
        f"bit-identical; mxu max error {err.max():.3e} absolute, "
        f"{rel.max():.3e} relative, {int(moved.sum())} position(s) "
        "differ")
    # the bf16 hi/lo split keeps ~16 bits of each per-base term: the
    # tolerance the CPU tests hold the mxu form to
    if err.max() > 1e-3:
        raise AssertionError(f"mxu split scan error {err.max():.3e}")


def _vcf_body(path):
    with gzip.open(path, "rt") as f:
        return [ln for ln in f if not ln.startswith("#")]


def _route_line(run_dir):
    with open(os.path.join(run_dir, "workspace", "workflow_log.txt")) as f:
        return next(ln.strip() for ln in f if "scoring route" in ln)


def phase_demo():
    from __graft_entry__ import demo_fasta_path
    from manta_tpu.workflow.run import run_workflow
    fasta = demo_fasta_path()
    want = _vcf_body(os.path.join(DEMO, "expectedResults",
                                  "somaticSV.vcf.gz"))
    for mode in ("jump", "exact"):
        run_dir = os.path.join(WORK, f"demo_{mode}")
        shutil.rmtree(run_dir, ignore_errors=True)
        t0 = time.perf_counter()
        run_workflow(
            [os.path.join(DEMO,
                          "HCC1954.NORMAL.30x.compare.COST16011_region.bam")],
            [os.path.join(DEMO, "G15512.HCC1954.1.COST16011_region.bam")],
            fasta, run_dir, is_exome=True, verbose=False,
            use_device_scoring=mode, cmdline=RUN_CMDLINE)
        route = _route_line(run_dir)
        if "jump kernel: cuda" not in route:
            raise AssertionError(f"demo {mode}: unexpected route {route}")
        got = _vcf_body(os.path.join(run_dir, "results", "variants",
                                     "somaticSV.vcf.gz"))
        if got != want:
            raise AssertionError(f"demo {mode}: somatic VCF differs from "
                                 "the expected results")
        log(f"[demo] {mode}: somatic VCF matches the expected results "
            f"({len(got)} records, {time.perf_counter() - t0:.1f}s)")


# host-only deep run: a child that never imports JAX
_HOST_CHILD = r"""
import json, sys, time
repo, prefix, run_dir, tiles, cmdline = sys.argv[1:6]
sys.path[:0] = [repo, repo + "/benchmarks"]
import stress_workload as sw
t0 = time.perf_counter()
bam, fa, reads = sw.generate(int(tiles), prefix, depth_frac=0.2,
                             strip_sa=True)
gen_s = time.perf_counter() - t0
from manta_tpu.workflow.run import run_workflow
run_workflow([], [bam], fa, run_dir, is_exome=True, n_jobs=1,
             verbose=False, use_device_scoring="off", cmdline=cmdline)
assert "jax" not in sys.modules, "host-only run imported jax"
print(json.dumps({"bam": bam, "fa": fa, "reads": reads, "gen_s": gen_s}))
"""


def phase_deep(card):
    from bench_jump_e2e import phase2_wall, vcfs
    from manta_tpu.align.device_jumpscore import DISPATCH_STATS
    from manta_tpu.workflow.run import run_workflow
    prefix = os.path.join(WORK, f"hspan{DEEP_TILES}")
    host_dir = os.path.join(WORK, "deep_host")
    dev_dir = os.path.join(WORK, "deep_jump")
    for d in (host_dir, dev_dir):
        shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-c", _HOST_CHILD, REPO, prefix, host_dir,
         str(DEEP_TILES), RUN_CMDLINE],
        capture_output=True, text=True)
    if child.returncode != 0:
        raise AssertionError("host-only deep run failed:\n"
                             + child.stderr[-4000:])
    info = json.loads(child.stdout.strip().splitlines()[-1])
    log(f"[deep] workload: {info['reads']} reads ({DEEP_TILES} tiles, "
        f"generated in {info['gen_s']:.1f}s); host-only run "
        f"{time.perf_counter() - t0:.1f}s incl. generation")
    before = dict(DISPATCH_STATS)
    shapes0 = DISPATCH_STATS["shapes"].copy()
    run_workflow([], [info["bam"]], info["fa"], dev_dir, is_exome=True,
                 n_jobs=1, verbose=False, use_device_scoring="jump",
                 cmdline=RUN_CMDLINE)
    route = _route_line(dev_dir)
    jobs = DISPATCH_STATS["jobs"] - before["jobs"]
    calls = DISPATCH_STATS["calls"] - before["calls"]
    shapes = DISPATCH_STATS["shapes"] - shapes0
    log(f"[deep] {route}")
    log(f"[deep] device dispatch: {calls} calls, {jobs} jobs, "
        f"{DISPATCH_STATS['rows'] - before['rows']} padded rows, "
        f"{DISPATCH_STATS['wall'] - before['wall']:.3f}s; shapes "
        f"(B, nq, nr1, nr2): {dict(sorted(shapes.items()))}")
    if jobs == 0 or "jump kernel: cuda" not in route:
        raise AssertionError("deep run scored no jobs on the card")
    host, dev = vcfs(host_dir), vcfs(dev_dir)
    if not host or host != dev:
        raise AssertionError("deep run: VCFs differ host vs device")
    log(f"[deep] {len(host)} VCFs byte-identical host vs device: "
        f"{', '.join(host)}")
    log(f"[deep] phase-2 wall: host-only {phase2_wall(host_dir):.3f}s, "
        f"device jump {phase2_wall(dev_dir):.3f}s ({card})")
    for d in (host_dir, dev_dir):
        shutil.rmtree(d, ignore_errors=True)
    for path in glob.glob(prefix + ".*"):
        os.remove(path)


def main():
    sys.path[:0] = [REPO, os.path.join(REPO, "benchmarks")]
    device, card = phase_device()
    os.makedirs(WORK, exist_ok=True)
    phase_kernels()
    phase_demo()
    phase_deep(card)
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
