"""Adversarial-genome (--repeats) simulator: reference structure,
mismap model invariants, and a fast end-to-end slice.

The at-scale behavior (graph complexity abort firing, precision under
segdup mismapping) is measured in benchmarks/wgs_workload.py --repeats
--check; these tests pin the
machinery itself. (reference: SVLocusSetOptions.hpp:50-54 abort
semantics; methods.tex:406 flank-uniqueness filter.)
"""

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "benchmarks"))


def _small_genome(rng, n=2, mb=1):
    import wgs_workload as W
    return [W.BASES[rng.integers(0, 4, mb * 1_000_000)] for _ in range(n)]


def test_repeat_structure_written_into_reference():
    import wgs_workload as W
    rng = np.random.default_rng(3)
    ref = _small_genome(rng)
    svs = [dict(chrom_i=0, pos=500_000, type="DEL", size=500, gt="het",
                ins_seq=None, gts=["het"])]
    fams = W.apply_repeat_structure(rng, ref, svs)
    kinds = {f["type"] for f in fams}
    assert kinds == {"tandem", "lowc", "segdup"}
    # tandem arrays are exactly periodic in the written reference
    tand = next(f for f in fams if f["type"] == "tandem")
    (t, b, e) = tand["copies"][0]
    u = tand["unit"]
    span = ref[t][b:e]
    assert np.array_equal(span[u:2 * u], span[:u])
    # segdup copies are ~99% identical to the donor
    sd = next(f for f in fams if f["type"] == "segdup")
    (t0, b0, e0) = sd["copies"][0]
    (t1, b1, e1) = sd["copies"][1]
    ident = (ref[t0][b0:e0] == ref[t1][b1:e1]).mean()
    assert 0.97 < ident < 1.0
    # a third of tandems anchor on SV positions: at least one array
    # contains the planted deletion junction
    assert any(f["type"] == "tandem" and f["copies"][0][0] == 0
               and f["copies"][0][1] <= 500_000 <= f["copies"][0][2]
               for f in fams)


def test_mismap_model_invariants():
    import wgs_workload as W
    rng = np.random.default_rng(4)
    ref = _small_genome(rng)
    fams = W.apply_repeat_structure(rng, ref, [])
    mm = W.MismapModel(fams, len(ref), p_move=1.0, p_move_hi_mapq=1.0,
                       p_mq0=0.0, p_jit=0.0, p_attract=0.0)
    # reads fully inside segdup copy 0 must all teleport to homologous
    # offsets of ANOTHER copy of the same family
    sd = next(f for f in fams if f["type"] == "segdup")
    (t0, b0, e0) = sd["copies"][0]
    n = 200
    p = rng.integers(b0, e0 - W.READ_LEN, n).astype(np.int64)
    t = np.full(n, t0, np.int64)
    t2, p2, mq = mm.apply(rng, t, p)
    moved = (t2 != t) | (p2 != p)
    assert moved.all()
    offs = p - b0
    ok = np.zeros(n, bool)
    for (ct, cb, ce) in sd["copies"][1:]:
        ok |= (t2 == ct) & (p2 - cb == offs)
    # a read can only fail the offset check if it teleported into a
    # DIFFERENT family copy that happens to overlap — not possible here
    assert ok.all()
    assert (mq == 60).all()      # p_move_hi_mapq=1.0 keeps confidence

    # satellite MAPQ0: reads inside a tandem array get mapq 0
    mm2 = W.MismapModel(fams, len(ref), p_move=0.0, p_mq0=1.0,
                        p_jit=0.0, p_attract=0.0)
    td = next(f for f in fams if f["type"] == "tandem")
    (tt, tb, te) = td["copies"][0]
    pt = rng.integers(tb, te - W.READ_LEN, 50).astype(np.int64)
    t3, p3, mq3 = mm2.apply(rng, np.full(50, tt, np.int64), pt)
    assert (mq3 == 0).all()
    assert np.array_equal(p3, pt)

    # attractor: outside-repeat reads teleport INTO an array span
    mm3 = W.MismapModel(fams, len(ref), p_move=0.0, p_mq0=0.0,
                        p_jit=0.0, p_attract=1.0)
    clean = []
    spans = [(t, b, e) for f in fams for (t, b, e) in f["copies"]]
    while len(clean) < 50:
        c = int(rng.integers(0, len(ref[0]) - W.READ_LEN))
        if not any(t == 0 and b - 200 <= c <= e for (t, b, e) in spans):
            clean.append(c)
    pc = np.array(clean, np.int64)
    t4, p4, _ = mm3.apply(rng, np.zeros(50, np.int64), pc)
    arrays = [(t, b, e) for f in fams if f["type"] == "tandem"
              for (t, b, e) in f["copies"]]
    for tt4, pp4 in zip(t4, p4):
        assert any(t == tt4 and b <= pp4 < e for (t, b, e) in arrays)


def test_repeats_generation_end_to_end(tmp_path):
    """Tiny --repeats generation: BAM written, sidecar annotation
    matches the flag, and mismapped evidence exists (anomalous pairs
    linking segdup copies; MAPQ0 reads inside arrays)."""
    import subprocess
    out = str(tmp_path / "rep")
    subprocess.run(
        [sys.executable, os.path.join(REPO, "benchmarks",
                                      "wgs_workload.py"),
         "--out", out, "--chroms", "2", "--mb", "2", "--depth", "12",
         "--repeats", "--seed", "5"],
        check=True, capture_output=True, timeout=300)
    assert os.path.exists(out + ".repeats.tsv")
    from manta_tpu.io.bam import BamReader
    rb = BamReader(out + ".bam")
    batch = rb.read_all()
    assert (batch.mapq == 0).sum() > 50          # MAPQ0 repeat reads
    # anomalous pairs: mate on another chromosome at meaningful rate
    # (segdup teleports + attractor; baseline noise_rate alone is 1e-4)
    cross = (batch.next_refid != batch.refid) & (batch.next_refid >= 0)
    assert cross.sum() > 0.0005 * batch.n
