"""End-to-end demo workflow: bit-identical somatic VCF vs the bundled
expected results (reference: src/demo/runMantaWorkflowDemo.py oracle)."""

import gzip

import pytest

from manta_tpu.workflow.run import run_workflow

import pathlib

_VEXP = (pathlib.Path(__file__).resolve().parent / "data" / "demo"
         / "expectedResults" / "somaticSV.vcf.gz")
EXPECTED = (str(_VEXP) if _VEXP.exists() else
            "/root/reference/src/demo/expectedResults/somaticSV.vcf.gz")


@pytest.fixture(scope="module")
def demo_run(tmp_path_factory, demo_fasta, normal_bam, tumor_bam):
    run_dir = str(tmp_path_factory.mktemp("demo_run"))
    run_workflow([normal_bam], [tumor_bam], demo_fasta, run_dir,
                 is_exome=True, generate_evidence_bam=True, verbose=False)
    return run_dir


def _records(path):
    with gzip.open(path, "rt") as f:
        return [l for l in f if not l.startswith("#")]


def test_somatic_vcf_matches_oracle(demo_run):
    got = _records(f"{demo_run}/results/variants/somaticSV.vcf.gz")
    want = _records(EXPECTED)
    assert got == want


def test_outputs_exist(demo_run):
    import os
    for name in ("candidateSV.vcf.gz", "candidateSmallIndels.vcf.gz",
                 "diploidSV.vcf.gz", "somaticSV.vcf.gz"):
        assert os.path.exists(f"{demo_run}/results/variants/{name}")
        assert os.path.exists(f"{demo_run}/results/variants/{name}.tbi")
    for name in ("alignmentStatsSummary.txt", "svLocusGraphStats.tsv",
                 "svCandidateGenerationStats.tsv"):
        assert os.path.exists(f"{demo_run}/results/stats/{name}")


def test_region_restricted_matches_oracle(tmp_path_factory, demo_fasta,
                                          normal_bam, tumor_bam):
    """The reference demo's EXACT invocation — two --region restrictions
    + --exome (reference: src/demo/runMantaWorkflowDemo.py:65-70) — must
    reproduce the expected VCF bit-for-bit, including the MantaBND
    locus:node ID serials. Guards the 200 kb segment-group clumping
    (one shared graph per group), the adopt-first merge order, and the
    per-group save/load compaction boundary."""
    run_dir = str(tmp_path_factory.mktemp("region_run"))
    run_workflow([normal_bam], [tumor_bam], demo_fasta, run_dir,
                 is_exome=True, verbose=False,
                 regions=["8:107652000-107655000", "11:94974000-94989000"])
    got = _records(f"{run_dir}/results/variants/somaticSV.vcf.gz")
    want = _records(EXPECTED)
    assert got == want


def test_call_regions_bed_matches_oracle(tmp_path_factory, demo_fasta,
                                         normal_bam, tumor_bam):
    """--callRegions BED restriction covering the demo neighborhoods
    produces the same scan plan as the equivalent --region pair, so the
    somatic VCF must still match the oracle bit-for-bit (reference:
    configManta.py --callRegions + getNextGenomeSegment BED
    intersection)."""
    d = tmp_path_factory.mktemp("bed_run")
    bed = str(d / "call.bed")
    with open(bed, "w") as f:
        f.write("track name=call\n")
        f.write("8\t107651999\t107655000\n")
        f.write("11\t94973999\t94989000\n")
    run_dir = str(d / "run")
    run_workflow([normal_bam], [tumor_bam], demo_fasta, run_dir,
                 is_exome=True, verbose=False, call_regions=bed)
    got = _records(f"{run_dir}/results/variants/somaticSV.vcf.gz")
    want = _records(EXPECTED)
    assert got == want


def test_parallel_matches_serial(tmp_path_factory, demo_fasta, normal_bam,
                                 tumor_bam, demo_run):
    """Fork-parallel phase execution must be bit-identical to serial.

    Runs in a subprocess so the fork-based workers never fork a
    JAX-initialized (multithreaded) test process."""
    import subprocess
    import sys
    run_dir = str(tmp_path_factory.mktemp("par_run"))
    subprocess.run(
        [sys.executable, "-m", "manta_tpu.workflow.run",
         "--normal-bam", normal_bam, "--tumor-bam", tumor_bam,
         "--reference", demo_fasta, "--run-dir", run_dir,
         "--exome", "-j", "2", "--generate-evidence-bam"],
        check=True, capture_output=True)
    for name in ("candidateSV.vcf.gz", "somaticSV.vcf.gz",
                 "diploidSV.vcf.gz"):
        got = _records(f"{run_dir}/results/variants/{name}")
        want = _records(f"{demo_run}/results/variants/{name}")
        assert got == want, name
    # evidence BAM record content must also be identical across modes
    import glob
    import os

    import numpy as np

    from manta_tpu.io.bam import BamReader
    ser = sorted(glob.glob(f"{demo_run}/results/evidence/evidence_*.bam"))
    par = sorted(glob.glob(f"{run_dir}/results/evidence/evidence_*.bam"))
    assert [os.path.basename(p) for p in ser] == \
        [os.path.basename(p) for p in par] and len(ser) == 2
    for s, p in zip(ser, par):
        a, b = BamReader(s).read_all(), BamReader(p).read_all()
        assert a.n == b.n
        for k in vars(a):
            va = getattr(a, k)
            if isinstance(va, np.ndarray):
                assert np.array_equal(va, getattr(b, k)), (s, k)


def test_rna_mode_smoke(tmp_path_factory, demo_fasta, tumor_bam):
    """RNA fusion mode end-to-end on the demo data (DNA reads, but the
    full splice-aware path executes)."""
    run_dir = str(tmp_path_factory.mktemp("rna_run"))
    run_workflow([tumor_bam], [], demo_fasta, run_dir, is_rna=True,
                 verbose=False)
    recs = _records(f"{run_dir}/results/variants/rnaSV.vcf.gz")
    assert len(recs) >= 4
    assert any("RNA_CONTIG=" in r for r in recs)
    assert any("RNA_FIRST" in r for r in recs)


def test_tumor_only_mode_smoke(tmp_path_factory, demo_fasta, tumor_bam):
    """Tumor-only calling end-to-end: tumorSV output with PR/SR counts."""
    run_dir = str(tmp_path_factory.mktemp("tumor_only_run"))
    run_workflow([], [tumor_bam], demo_fasta, run_dir, is_exome=True,
                 verbose=False)
    recs = _records(f"{run_dir}/results/variants/tumorSV.vcf.gz")
    assert len(recs) >= 4
    assert all("PR:" in r.split("\t")[8] or r.split("\t")[8] == "PR"
               for r in recs)


def test_cram_inputs_match_oracle(tmp_path_factory, demo_fasta, normal_bam,
                                  tumor_bam):
    """The full workflow on CRAM inputs (converted losslessly from the
    demo BAMs) produces the same somatic VCF as the oracle."""
    import os

    from cramgen import CramRec, write_cram
    from manta_tpu.io.bam import BamReader
    from manta_tpu.io.fasta import FastaReader
    from test_cram import aux_split

    tmp = tmp_path_factory.mktemp("cram_inputs")
    ops = "MIDNSHP=X"
    crams = []
    for src_path in (normal_bam, tumor_bam):
        src = BamReader(src_path)
        b = src.read_all()
        fr = FastaReader(demo_fasta)
        ref_seqs = {tid: fr.fetch(nm, 0, fr.chrom_length(nm))
                    for tid, nm in enumerate(src.header.ref_names)
                    if nm in fr._index}
        recs = []
        for i in range(b.n):
            flag = int(b.flag[i])
            cigar = [(ops[int(c) & 0xF], int(c) >> 4)
                     for c in b.cigar_arr(i)]
            qual = bytes(b.qual_arr(i))
            if qual and qual[0] == 0xFF:
                qual = None
            mate = ("detached", int(b.next_refid[i]), int(b.next_pos[i]),
                    int(b.tlen[i])) if flag & 0x1 else None
            tags = aux_split(bytes(b.tags[b.tag_off[i]:b.tag_off[i + 1]]))
            recs.append(CramRec(
                b.name_str(i), flag, int(b.refid[i]), int(b.pos[i]),
                int(b.mapq[i]), cigar, b.seq_str(i).encode(), qual,
                tags=tags, mate=mate))
        extra = [ln for ln in src.header.text.splitlines()
                 if ln.startswith(("@RG", "@PG"))]
        out = str(tmp / (os.path.basename(src_path)
                         .replace(".bam", ".cram")))
        # gzip blocks keep the (pure-Python) test encoder fast; the
        # rANS decode path is covered by tests/test_cram.py round-trips
        write_cram(out, src.header.ref_names, src.header.ref_lengths,
                   ref_seqs, recs, compress="gzip", per_container=2000,
                   extra_header_lines=extra)
        crams.append(out)
    run_dir = str(tmp / "run")
    run_workflow([crams[0]], [crams[1]], demo_fasta, run_dir,
                 is_exome=True, verbose=False)
    got = _records(f"{run_dir}/results/variants/somaticSV.vcf.gz")
    want = _records(EXPECTED)
    assert got == want


def test_joint_multi_sample_germline(tmp_path_factory, demo_fasta,
                                     normal_bam, tumor_bam):
    """Joint diploid calling over two samples (reference: germline mode
    with up to ~10 diploid samples): per-sample columns appear in the
    diploid VCF and candidate generation covers both inputs."""
    run_dir = str(tmp_path_factory.mktemp("joint_run"))
    run_workflow([normal_bam, tumor_bam], [], demo_fasta, run_dir,
                 is_exome=True, verbose=False)
    with gzip.open(f"{run_dir}/results/variants/diploidSV.vcf.gz",
                   "rt") as f:
        header = [l for l in f if l.startswith("#CHROM")][0]
    cols = header.rstrip("\n").split("\t")
    assert cols[9:] == ["HCC1954_BL", "HCC1954"]
    cand = _records(f"{run_dir}/results/variants/candidateSV.vcf.gz")
    assert len(cand) == 6


def test_device_scoring_matches_oracle(tmp_path_factory, demo_fasta,
                                       normal_bam, tumor_bam):
    """Full workflow with the device path forced on — split-read
    scanning through the XLA scan kernel and contig jump scoring through
    the device jump-score kernel (winner-only host traceback) — must be
    bit-identical to the oracle. Both kernels reproduce the host math
    exactly (float32 accumulation order / int32 DP), so device routing
    is purely a performance choice (reference: SVScorerSplit.cpp:130,
    GlobalJumpAlignerImpl.hpp). Runs on whatever the session JAX backend
    is (CPU here, the GPU on a card)."""
    run_dir = str(tmp_path_factory.mktemp("device_run"))
    run_workflow([normal_bam], [tumor_bam], demo_fasta, run_dir,
                 is_exome=True, verbose=False, use_device_scoring="exact")
    got = _records(f"{run_dir}/results/variants/somaticSV.vcf.gz")
    want = _records(EXPECTED)
    assert got == want


def test_five_sample_joint_germline_genotypes(tmp_path_factory,
                                              demo_fasta):
    """Joint diploid calling at N=5 (reference: germline mode scales to
    ~10 diploid samples, docs/userGuide/README.md:50-69) on a simulated
    heterozygous 500 b deletion carried by samples S1-S3: the deletion
    must be emitted with per-sample genotypes 0/1 in every carrier and
    0/0 in both non-carriers, with PASS-grade quality in carriers."""
    import re

    from simdata import make_deletion_dataset

    d = tmp_path_factory.mktemp("five_sample")
    fa, bams, names = make_deletion_dataset(d)
    run_dir = str(d / "run")
    run_workflow(bams, [], fa, run_dir, is_exome=True, verbose=False)
    with gzip.open(f"{run_dir}/results/variants/diploidSV.vcf.gz",
                   "rt") as f:
        lines = f.readlines()
    header = [l for l in lines if l.startswith("#CHROM")][0]
    assert header.rstrip("\n").split("\t")[9:] == names
    records = [l for l in lines if not l.startswith("#")]
    dels = [r for r in records if "SVTYPE=DEL" in r]
    assert dels, f"no deletion called: {records}"
    rec = dels[0].rstrip("\n").split("\t")
    pos = int(rec[1])
    assert abs(pos - 10000) < 50, rec[:8]
    fmt = rec[8].split(":")
    gt_i = fmt.index("GT")
    gts = [rec[9 + si].split(":")[gt_i] for si in range(5)]
    assert gts[:3] == ["0/1", "0/1", "0/1"], gts
    assert gts[3:] == ["0/0", "0/0"], gts


def test_ten_sample_joint_germline_genotypes(tmp_path_factory,
                                             demo_fasta):
    """Joint diploid calling at the reference's stated sample-count
    ceiling, N=10 (reference: docs/userGuide/README.md:50-69 'typically
    fewer than ten diploid samples'), with all three genotype classes
    present: a 500 b deletion carried het (0/1) by four samples, hom
    (1/1) by two, and absent (0/0) from four. Every sample column must
    genotype correctly and the carrier depth must not degrade the
    call (single multi-sample scoring pass, per-sample PL/GQ)."""
    from simdata import make_deletion_dataset

    d = tmp_path_factory.mktemp("ten_sample")
    copies = (1, 1, 2, 0, 0, 1, 2, 0, 1, 0)
    fa, bams, names = make_deletion_dataset(d, carriers=copies)
    run_dir = str(d / "run")
    run_workflow(bams, [], fa, run_dir, is_exome=True, verbose=False)
    with gzip.open(f"{run_dir}/results/variants/diploidSV.vcf.gz",
                   "rt") as f:
        lines = f.readlines()
    header = [l for l in lines if l.startswith("#CHROM")][0]
    assert header.rstrip("\n").split("\t")[9:] == names
    records = [l for l in lines if not l.startswith("#")]
    dels = [r for r in records if "SVTYPE=DEL" in r]
    assert dels, f"no deletion called: {records}"
    rec = dels[0].rstrip("\n").split("\t")
    assert abs(int(rec[1]) - 10000) < 50, rec[:8]
    fmt = rec[8].split(":")
    gt_i = fmt.index("GT")
    want = {0: "0/0", 1: "0/1", 2: "1/1"}
    gts = [rec[9 + si].split(":")[gt_i] for si in range(10)]
    assert gts == [want[c] for c in copies], gts


def test_large_insertion_semi_assembled(tmp_path_factory):
    """Semi-assembled large-insertion path (reference:
    SVCandidateAssemblyRefiner processLargeInsertion:833 +
    isLargeInsertAlignment:611): a 400 b novel insertion whose interior
    reads surface only as unmapped shadows must be emitted as an <INS>
    with LEFT/RIGHT_SVINSSEQ flanks that are true prefixes/suffixes of
    the planted sequence, PASS in the diploid output."""
    import re

    from simdata import make_insertion_dataset

    d = tmp_path_factory.mktemp("large_ins")
    fa, bams, names, ins_seq = make_insertion_dataset(d)
    run_dir = str(d / "run")
    run_workflow(bams, [], fa, run_dir, is_exome=True, verbose=False)
    with gzip.open(f"{run_dir}/results/variants/diploidSV.vcf.gz",
                   "rt") as f:
        records = [l for l in f if not l.startswith("#")]
    ins = [r for r in records if "SVTYPE=INS" in r]
    assert ins, records
    rec = ins[0].rstrip("\n").split("\t")
    assert rec[4] == "<INS>"
    assert abs(int(rec[1]) - 10000) <= 2, rec[:2]
    assert rec[6] == "PASS", rec[6]
    info = dict(kv.split("=", 1) for kv in rec[7].split(";")
                if "=" in kv)
    left = info["LEFT_SVINSSEQ"]
    right = info["RIGHT_SVINSSEQ"]
    assert len(left) >= 20 and len(right) >= 20
    assert ins_seq.startswith(left), "left flank not an insertion prefix"
    assert ins_seq.endswith(right), "right flank not an insertion suffix"


def test_rna_fusion_e2e(tmp_path_factory):
    """RNA fusion mode end-to-end (reference: --rna fusion calling,
    scoreRNASV + RNA spanning assembly/intron aligner): a simulated
    chrA->chrB fusion transcript must produce a reciprocal PASS BND
    pair at the exact junction with split + spanning support and the
    RNA-specific annotations."""
    from simdata import make_fusion_dataset

    d = tmp_path_factory.mktemp("rna_fusion")
    fa, bam, (c1, p1, c2, p2) = make_fusion_dataset(d)
    run_dir = str(d / "run")
    run_workflow([bam], [], fa, run_dir, is_rna=True, verbose=False)
    with gzip.open(f"{run_dir}/results/variants/rnaSV.vcf.gz", "rt") as f:
        records = [l.rstrip("\n").split("\t") for l in f
                   if not l.startswith("#")]
    assert len(records) == 2, records
    by_chrom = {r[0]: r for r in records}
    ra, rb = by_chrom[c1], by_chrom[c2]
    assert int(ra[1]) == p1 and abs(int(rb[1]) - p2) <= 1
    assert ra[6] == "PASS" and rb[6] == "PASS"
    # reciprocal MATEID linkage
    def info(r):
        return dict(kv.split("=", 1) for kv in r[7].split(";") if "=" in kv)
    ia, ib = info(ra), info(rb)
    assert ia["MATEID"] == rb[2] and ib["MATEID"] == ra[2]
    # transcript starts on chrA: the 5' partner carries RNA_FIRST
    assert "RNA_FIRST" in ra[7] and "RNA_FIRST" not in rb[7]
    # split + spanning support present in the sample column
    fmt = ra[8].split(":")
    vals = ra[9].split(":")
    support = dict(zip(fmt, vals))
    pr = int(support["PR"].split(",")[1])
    sr = int(support["SR"].split(",")[1])
    assert pr > 10 and sr > 10, support


def test_parallel_edge_stats_lifetimes_sum(tmp_path_factory, demo_fasta,
                                           normal_bam, tumor_bam):
    """Merged phase-2 edge stats must sum bin-worker lifetimes
    (GSCEdgeStatsData::merge semantics): SVGenTotalHours carries real
    CPU time and NonEdgeHours is non-negative. Regression for the
    round-3 fix — the parent previously 'closed' each pickled bin
    tracker against its own process clock, reporting ~zero total CPU
    and negative non-edge time."""
    import re
    import subprocess
    import sys
    run_dir = str(tmp_path_factory.mktemp("stats_run"))
    subprocess.run(
        [sys.executable, "-m", "manta_tpu.workflow.run",
         "--normal-bam", normal_bam, "--tumor-bam", tumor_bam,
         "--reference", demo_fasta, "--run-dir", run_dir,
         "--exome", "-j", "2"],
        check=True, capture_output=True)
    tsv = open(f"{run_dir}/results/stats/"
               "svCandidateGenerationStats.tsv").read()

    def hours(label):
        m = re.search(rf"{label}\t([-0-9.]+)h wall, ([-0-9.]+)h user \+ "
                      rf"([-0-9.]+)h system", tsv)
        assert m, label
        return tuple(float(g) for g in m.groups())

    gen_wall, gen_user, gen_sys = hours("SVGenTotalHours")
    ne_wall, ne_user, ne_sys = hours("NonEdgeHours")
    # the demo's per-worker CPU rounds to 0 at 4-decimal hours, so the
    # load-bearing assertions are the sign invariants the bug violated
    assert gen_wall > 0
    assert ne_wall >= 0 and ne_user >= -1e-9 and ne_sys >= -1e-9, \
        "non-edge time negative: lifetimes not summed across workers"


def test_small_tandem_dup_called_from_sa_splits(tmp_path_factory):
    """A ~220 bp tandem duplication must be called as DUP:TANDEM from
    SA split-read evidence: its everted pairs fall inside the normal
    fragment-size range and are (correctly, matching the reference's
    AlignmentPairAnalyzer) rejected by the pair gate, so the SA path
    is the only route — the round-3 WGS-simulation finding that took
    DUP recall from 75% to 97%."""
    import importlib.util
    import pathlib

    import numpy as np

    from manta_tpu.io.bamwriter import BamWriter
    from manta_tpu.workflow.run import run_workflow

    spec = importlib.util.spec_from_file_location(
        "wgs_workload",
        pathlib.Path(__file__).resolve().parent.parent / "benchmarks" /
        "wgs_workload.py")
    W = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(W)

    rng = np.random.default_rng(3)
    # 220 bp keeps the everted pairs' implied fragment inside the
    # proper-pair range (so the pair path CANNOT call this); 60x makes
    # the split-read diploid QUAL clear the Q10 output threshold
    # (Q93 measured; a 35x het sits at Q8 — the same marginal class
    # as the seven WGS-simulation drops)
    ref_len, dup_pos, dup_len = 400_000, 200_000, 220
    ref = W.BASES[rng.integers(0, 4, ref_len)]
    svs = [dict(chrom_i=0, pos=dup_pos, type="DUP", size=dup_len,
                gt="het", ins_seq=None)]
    haps = W.build_haplotypes([ref], [ref_len], svs, [])
    for dchroms in haps:
        for dc in dchroms:
            dc.names = ["chrS"]

    d = tmp_path_factory.mktemp("smalldup")
    W.write_fasta(str(d / "sim.fa"), ["chrS"], [ref])
    header = ("@HD\tVN:1.6\tSO:coordinate\n"
              f"@SQ\tSN:chrS\tLN:{ref_len}\n"
              "@RG\tID:rg1\tSM:S1\n")
    bw = BamWriter(str(d / "s1.bam"), header, ["chrS"], [ref_len])
    w = W._BatchWriter(bw)
    W.simulate(rng, [ref], haps, w, depth=60, err_rate=0.0,
               noise_rate=0.0, log=lambda m: None)
    bw.close()

    run_dir = str(d / "run")
    run_workflow([str(d / "s1.bam")], [], str(d / "sim.fa"), run_dir,
                 verbose=False)
    import gzip
    recs = [l.split("\t") for l in gzip.open(
        f"{run_dir}/results/variants/diploidSV.vcf.gz", "rt")
        if not l.startswith("#")]
    dups = [r for r in recs if "DUP:TANDEM" in r[4]
            and abs(int(r[1]) - dup_pos) <= 50 and r[6] == "PASS"]
    assert dups, "small tandem DUP not called from SA split evidence"


def test_edge_chunk_staging_parity(tmp_path, demo_fasta, normal_bam,
                                   tumor_bam, monkeypatch):
    """MANTA_TPU_EDGE_CHUNK changes only the staging order (cross-edge
    batching for device dispatch); outputs must be byte-identical to
    the per-edge default — the somatic VCF still matches the oracle."""
    monkeypatch.setenv("MANTA_TPU_EDGE_CHUNK", "8")
    run_dir = str(tmp_path / "chunked")
    run_workflow([normal_bam], [tumor_bam], demo_fasta, run_dir,
                 is_exome=True, verbose=False)
    got = gzip.open(
        f"{run_dir}/results/variants/somaticSV.vcf.gz", "rt").read()
    want = gzip.open(EXPECTED, "rt").read()
    strip = lambda t: [l for l in t.splitlines()
                       if not l.startswith("#")]
    assert strip(got) == strip(want)
