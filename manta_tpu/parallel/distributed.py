"""Multi-host scale-out: jax.distributed runtime + host-sharded phases.

The reference scales across one machine's cores via pyflow task
scheduling (mantaWorkflow.py); this analogue spans several hosts:

- device collectives stay within each host's devices (the mesh
  shardings in parallel/mesh.py + scan_parallel.py);
- cross-host coupling is limited to the phase boundaries, where
  genome-segment-group graphs and edge-bin VCF shards are exchanged
  through a shared directory (e.g. NFS) exactly like the reference's
  per-task file handoff — graphs are variable-size host objects, so a
  filesystem/DCN exchange with a DETERMINISTIC merge order (group
  index, then bin index) replaces collective gathers;
- host 0 performs the ordered reductions (MergeSVLoci semantics via
  workflow.run.merge_saved_graphs) and emits the single final VCF set.

Work partitioning is a pure function of (item index, host count), so
any host count produces bit-identical results to a single-host run.

Usage on a multi-host slice (one process per host):

    import manta_tpu.parallel.distributed as dist
    dist.init_runtime()          # jax.distributed via env/args
    dist.run_host_phase1(...)    # every host
    dist.barrier(shared_dir, "phase1", host_id, n_hosts)
    if host_id == 0:
        dist.finalize_phase1(...)
"""

from __future__ import annotations

import json
import os
import time


def init_runtime(coordinator_address: str | None = None,
                 num_processes: int | None = None,
                 process_id: int | None = None):
    """Initialize the jax.distributed runtime (no-op for a single
    process). Without arguments JAX falls back to its cluster
    autodetection, which finds nothing on a plain GPU host: pass
    coordinator_address ("localhost:<port>" on one machine),
    num_processes and process_id."""
    import jax
    if num_processes == 1:
        return
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def host_items(n_items: int, host_id: int, n_hosts: int) -> list[int]:
    """Deterministic contiguous partition of item indices across hosts
    (contiguous keeps each host's genome reads clustered for IO
    locality; the merge order is by item index regardless of owner)."""
    per = (n_items + n_hosts - 1) // n_hosts
    return list(range(host_id * per, min((host_id + 1) * per, n_items)))


def barrier(shared_dir: str, phase: str, host_id: int, n_hosts: int,
            poll_s: float = 0.5, timeout_s: float = 86400.0):
    """File-sentinel barrier over the shared directory: host h writes
    <phase>.host<h>.done, then waits for all hosts' sentinels."""
    bdir = os.path.join(shared_dir, "barriers")
    os.makedirs(bdir, exist_ok=True)
    mine = os.path.join(bdir, f"{phase}.host{host_id:04d}.done")
    tmp = mine + ".tmp"
    with open(tmp, "w") as f:
        f.write(str(time.time()))
    os.replace(tmp, mine)
    want = [os.path.join(bdir, f"{phase}.host{h:04d}.done")
            for h in range(n_hosts)]
    t0 = time.monotonic()
    while not all(os.path.exists(p) for p in want):
        if time.monotonic() - t0 > timeout_s:
            missing = [p for p in want if not os.path.exists(p)]
            raise TimeoutError(
                f"barrier '{phase}': missing {len(missing)} host "
                f"sentinels, e.g. {missing[0]}")
        time.sleep(poll_s)


def plan_phase1(bams: list[str], reference: str, regions=None,
                call_regions: str | None = None, scan_size_mb: int = 12):
    """The shared, deterministic phase-1 work plan: segment the genome
    (workflow.run.plan_scan_segments — the same planner the single-host
    workflow uses) and clump into the reference's 200 kb groups. Every
    host derives the identical plan from the same inputs."""
    from ..graph.finder import group_segments
    from ..io.bam import open_alignment_reader
    from ..workflow.run import plan_scan_segments
    header = open_alignment_reader(bams[0], reference).header
    region_list = plan_scan_segments(header, regions, call_regions,
                                     scan_size_mb)
    return group_segments(region_list)


def run_host_phase1(host_id: int, n_hosts: int, shared_dir: str,
                    bams: list[str], is_tumor: list[bool], reference: str,
                    stats_path: str, regions=None, scan_size_mb: int = 12,
                    chrom_depths: dict | None = None,
                    min_candidate_variant_size: int = 8,
                    min_edge_observations: int = 3):
    """Build this host's share of per-group graphs into shared_dir.

    Graph files are named by group index so the host-0 merge order is
    independent of which host produced each file."""
    from ..core.fragstats import ReadGroupStatsSet
    from ..graph.finder import estimate_sv_loci
    from ..graph.locusgraph import SVLocusSetOptions
    from ..io.bam import open_alignment_reader
    from ..io.fasta import FastaReader
    from ..scan.scanner import ScannerOptions, SVScanner

    groups = plan_phase1(bams, reference, regions,
                         scan_size_mb=scan_size_mb)
    mine = host_items(len(groups), host_id, n_hosts)
    gdir = os.path.join(shared_dir, "graphParts")
    os.makedirs(gdir, exist_ok=True)

    stats_set = ReadGroupStatsSet.load(stats_path)
    fasta = FastaReader(reference)
    # open once per host: each estimate_sv_loci call would otherwise
    # re-parse every BAI index per group
    readers = [open_alignment_reader(p, reference) for p in bams]
    header = readers[0].header
    stats_list = [stats_set.get_stats(p) for p in bams]
    scanner = SVScanner(
        ScannerOptions(min_candidate_variant_size=min_candidate_variant_size),
        [s.frag_stats for s in stats_list],
        header.ref_lengths, header.ref_names)
    graph_opt = SVLocusSetOptions(
        observation_weight=3,
        min_merge_edge_observations=min_edge_observations)

    for gi in mine:
        part = estimate_sv_loci(bams, is_tumor, scanner, graph_opt,
                                groups[gi], fasta,
                                chrom_depths=chrom_depths,
                                readers=readers)
        out = os.path.join(gdir, f"part_{gi:06d}.npz")
        part.save(out + ".tmp.npz")
        os.replace(out + ".tmp.npz", out)
    manifest = os.path.join(gdir, f"manifest.host{host_id:04d}.json")
    with open(manifest, "w") as f:
        json.dump({"host": host_id, "groups": mine}, f)
    return [os.path.join(gdir, f"part_{gi:06d}.npz") for gi in mine]


def finalize_phase1(shared_dir: str, n_groups: int):
    """Host-0 ordered reduce: adopt group-0's graph, merge the rest in
    group order, finalize (noise clean), return the merged set
    (reference: MergeSVLoci.cpp:48-69)."""
    from ..workflow.run import merge_saved_graphs
    gdir = os.path.join(shared_dir, "graphParts")
    paths = [os.path.join(gdir, f"part_{gi:06d}.npz")
             for gi in range(n_groups)]
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(
            f"{len(missing)} group graphs missing, e.g. {missing[0]}")
    merged = merge_saved_graphs(paths)
    merged.finalize()
    return merged


def bootstrap_shared_run(normal_bams: list[str], tumor_bams: list[str],
                         reference: str, run_dir: str, **kw):
    """Host-0 phase-0/1 bootstrap on the shared run directory: fragment
    stats, chromosome depth, and the merged breakend graph are written
    as the standard workspace checkpoints, then the run stops before
    candidate generation (reference: the pyflow DAG's stats/graph tasks
    feeding one GenerateSVCandidates stage, mantaWorkflow.py:832-849)."""
    from ..workflow.run import run_workflow
    return run_workflow(normal_bams, tumor_bams, reference, run_dir,
                        stop_after="graph", **kw)


def run_host_phase2(host_id: int, n_hosts: int,
                    normal_bams: list[str], tumor_bams: list[str],
                    reference: str, run_dir: str, n_jobs: int = 1, **kw):
    """Process this host's slice of the GLOBAL phase-2 edge-bin plan
    against the shared run directory (phases 0-1 artifacts must already
    exist; see bootstrap_shared_run). The plan is n_hosts * n_jobs
    observation-weighted bins derived identically on every host
    (reference: EdgeRetrieverBin.cpp:38-61 equal-work binning +
    the legacy --bin-index/--bin-count multi-process fan-out,
    mantaWorkflow.py:510-511); host h owns bins [h*n_jobs, (h+1)*n_jobs)
    and writes per-bin VCF/evidence shards + completion pickles."""
    from ..workflow.run import run_workflow
    return run_workflow(
        normal_bams, tumor_bams, reference, run_dir,
        n_jobs=n_jobs, is_rescore=False,
        hygen_bin_count=n_hosts * n_jobs,
        hygen_bin_range=(host_id * n_jobs, (host_id + 1) * n_jobs),
        tracker_tag=f".host{host_id:04d}", **kw)


def finalize_phase2(n_hosts: int,
                    normal_bams: list[str], tumor_bams: list[str],
                    reference: str, run_dir: str, n_jobs: int = 1, **kw):
    """Host-0 ordered reduce of phase 2: merge every host's per-bin
    shards in global bin order, write the aggregate edge stats and
    runtime log, and run the final sort/filter/bgzip/tabix output stage
    (reference: SVWriter's single-process output + mantaWorkflow.py
    sortAllVcfs). Raises if any host's bins are missing or stale."""
    from ..workflow.run import run_workflow
    return run_workflow(
        normal_bams, tumor_bams, reference, run_dir,
        n_jobs=n_jobs, hygen_bin_count=n_hosts * n_jobs, **kw)
