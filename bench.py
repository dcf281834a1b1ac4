"""Headline benchmark: end-to-end throughput + Amdahl-honest WGS projection.

Runs the full production pipeline — fragment stats, graph build/merge,
candidate generation, assembly, contig jump alignment, scoring, output
— over the tiled HCC1954 stress workload (benchmarks/stress_workload.py)
at full host parallelism, then reports:

  value / vs_baseline : the 20-core Amdahl-corrected projection of a
      50x NA12878 WGS run (840 M reads) from the measured per-read CPU
      cost and the measured serial phase-boundary tail, compared
      against the reference's published "< 20 minutes on 20 physical
      cores" figure (/root/reference/README.md:8-10,
      docs/userGuide/README.md:474-478).  vs_baseline > 1 means the
      projection beats the reference's bound.  The projection is
      conservative two ways: the stress workload is ~6x deeper than
      50x WGS (per-read costs overstate WGS costs), and the serial
      tail is scaled linearly by reads although the graph boundary
      cost scales with graph size, not read count.
  phase2_graph_edges_per_s : cross-round tracking metric (round 1: 27,
      round 2: 82-84 on 2 cores).
  device_contigs_per_s : with --device, contig jump-scoring throughput
      of the GPU's production kernel at the production shape (median
      of block_until_ready-timed calls, benchmarks/device_timing.py),
      with the JAX device and the card's name and power limit. Asking
      for it on a machine without a GPU is an error; without --device
      it is null.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

WGS_READS_M = 840.0          # 50x NA12878, docs/userGuide/README.md:474
BASELINE_WALL_MIN = 20.0     # reference's published bound, 20 cores
BASELINE_CORES = 20


def measure_host():
    from manta_tpu.workflow.run import run_workflow
    n_cores = os.cpu_count() or 1

    bam, fa = "/tmp/bench_stress.bam", "/tmp/bench_stress.fa"
    if not (os.path.exists(bam) and os.path.exists(fa)):
        subprocess.run(
            [sys.executable,
             os.path.join(REPO, "benchmarks", "stress_workload.py"),
             "--tiles", "32", "--out", "/tmp/bench_stress"],
            check=True, capture_output=True)

    import resource
    run_dir = tempfile.mkdtemp(prefix="bench_")
    r0 = resource.getrusage(resource.RUSAGE_SELF)
    c0 = resource.getrusage(resource.RUSAGE_CHILDREN)
    t0 = time.perf_counter()
    run_workflow([], [bam], fa, run_dir, is_exome=True,
                 n_jobs=n_cores, verbose=False)
    wall = time.perf_counter() - t0
    r1 = resource.getrusage(resource.RUSAGE_SELF)
    c1 = resource.getrusage(resource.RUSAGE_CHILDREN)
    cpu_s = (r1.ru_utime - r0.ru_utime + r1.ru_stime - r0.ru_stime
             + c1.ru_utime - c0.ru_utime + c1.ru_stime - c0.ru_stime)

    log = open(os.path.join(run_dir, "workspace",
                            "workflow_log.txt")).read()
    m = re.search(r"processed (\d+) graph edges", log)
    n_edges = int(m.group(1)) if m else 0
    # phase-2 span from the millisecond log stamps (the stats TSV's
    # SVGenTotalHours now sums worker lifetimes across processes, the
    # reference's merge semantics — a utilization figure, not a span)
    import datetime

    def stamp(pattern):
        mm = re.search(rf"\[([0-9T:.-]+)\] {pattern}", log)
        return datetime.datetime.fromisoformat(mm.group(1)) if mm else None

    t_a = stamp("generating and scoring SV candidates")
    t_b = stamp(r"processed \d+ graph edges")
    phase2_s = (t_b - t_a).total_seconds() if t_a and t_b else wall

    # serial phase-boundary tail, from the instrumented log stages:
    # graph merge + finalize + save + phase-2 load + shard merge +
    # final VCF sort (all single-process sections)
    tail = 0.0
    for pat in (r"merged \d+ graph parts in ([0-9.]+)s",
                r"finalized in ([0-9.]+)s, saved in ([0-9.]+)s",
                r"loaded for phase 2 in ([0-9.]+)s",
                r"bin shards in ([0-9.]+)s",
                r"final VCFs in ([0-9.]+)s"):
        for mm in re.finditer(pat, log):
            tail += sum(float(g) for g in mm.groups())
    shutil.rmtree(run_dir, ignore_errors=True)

    # reads in the 32-tile workload (fixed by the generator)
    reads_m = 358144 / 1e6
    return {
        "cores": n_cores,
        "e2e_s": round(wall, 2),
        "cpu_s": round(cpu_s, 1),
        "edges": n_edges,
        "phase2_s": round(phase2_s, 2),
        "edges_per_s": round(n_edges / max(phase2_s, 1e-9), 2),
        "serial_tail_s": round(tail, 2),
        "reads_m": reads_m,
    }


def project_wgs(host):
    """Amdahl-corrected 20-core projection of the reference's headline
    WGS case from measured constants: parallel CPU work scaled by
    reads / 20 cores, plus the measured serial tail scaled by reads."""
    cpu_per_mread = (host["cpu_s"] - host["serial_tail_s"]) \
        / host["reads_m"]
    tail_per_mread = host["serial_tail_s"] / host["reads_m"]
    par_s = cpu_per_mread * WGS_READS_M / BASELINE_CORES
    ser_s = tail_per_mread * WGS_READS_M
    return {
        "wgs_projected_min": round((par_s + ser_s) / 60.0, 2),
        "wgs_parallel_min": round(par_s / 60.0, 2),
        "wgs_serial_min": round(ser_s / 60.0, 2),
        "cpu_s_per_mread": round(cpu_per_mread, 1),
        "serial_s_per_mread": round(tail_per_mread, 3),
    }


def measure_device():
    """Contig jump-scoring throughput of the GPU's production kernel at
    the production shape; exits with an error when there is no GPU."""
    sys.path.insert(0, os.path.join(REPO, "benchmarks"))
    import device_timing as dt

    dev = dt.card()
    rec = dt.bench_jump("cuda", dev, None, reps=7)["production"]
    return {"device_contigs_per_s": rec["contigs_per_s"],
            "device_gcells_per_s": rec["gcells_per_s"],
            "device_kernel_median_s": rec["median_s"],
            "device": dev}


def load_measured():
    """The at-scale measured-run artifact (bench_wgs_at_scale.py),
    committed under benchmarks/results/. When present, its 20-core
    projection — anchored at a measured >=50%-of-840M-read run rather
    than a 0.36M-read extrapolation — is the headline."""
    import glob
    best = None
    for p in sorted(glob.glob(os.path.join(
            REPO, "benchmarks", "results", "wgs_measured*.json"))):
        try:
            d = json.load(open(p))
        except Exception:
            continue
        if d.get("device_scoring") not in ("off", None):
            continue          # headline = default host config
        if best is None or d.get("reads_m", 0) > best.get("reads_m", 0):
            best = d
    return best


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", action="store_true",
                    help="also time the GPU jump kernel (needs a GPU)")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    host = measure_host()
    proj = project_wgs(host)
    dev = measure_device() if args.device else None
    measured = load_measured()

    if measured is not None:
        value = measured["wgs840_20core_projection_min"]
        out = {
            "metric": "wgs_20core_projection_measured",
            "value": value,
            "unit": "min",
            # >1 = beats the reference's published 20-min bound;
            # anchored at a measured at-scale run (see measured_*)
            "vs_baseline": round(BASELINE_WALL_MIN / value, 3),
            "measured_reads_m": measured["reads_m"],
            "measured_pct_of_840m": measured["pct_of_840m"],
            "measured_wall_min": measured["wall_min"],
            "measured_cores": measured["cores"],
            "measured_cpu_s": measured["cpu_s"],
            "measured_peak_rss_gb": measured["peak_rss_gb"],
            # honest memory datum vs the reference's 2.35 GB:
            # tree-summed Pss_Anon peak (ru_maxrss conflates the
            # mmap'd BAM's reclaimable file pages)
            "measured_peak_pss_anon_gb": measured.get(
                "peak_pss_anon_gb"),
            "measured_edges_per_s": measured["edges_per_s"],
            "measured_utc": measured["measured_utc"],
            # read scale is MEASURED (>=99% of 840M when the r05
            # artifact is present); scaling 2 measured cores to the
            # baseline's 20 is the only remaining extrapolation
            "extrapolation": (
                f"cores {measured['cores']}->20 only; read scale "
                f"measured at {measured['pct_of_840m']}% of 840M"),
        }
    else:
        out = {
            "metric": "wgs_20core_projection",
            "value": proj["wgs_projected_min"],
            "unit": "min",
            "vs_baseline": round(
                BASELINE_WALL_MIN / proj["wgs_projected_min"], 3),
        }
    out.update({
        "phase2_graph_edges_per_s": host["edges_per_s"],
        **{k: v for k, v in host.items()},
        **proj,
    })
    if dev:
        out.update(dev)
    else:
        out["device_contigs_per_s"] = None
    print(json.dumps(out))


if __name__ == "__main__":
    main()
