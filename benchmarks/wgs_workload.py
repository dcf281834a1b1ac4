"""WGS-shaped validation workload: multi-chromosome diploid genome with
a heterogeneous SV mix at realistic density, plus a self-consistent
truth oracle.

The round-2 stress workload (stress_workload.py) tiles one somatic
junction at ~290x — deep, narrow, homogeneous. The reference's headline
case is the opposite: 30-50x WGS germline, wide and shallow, with a mix
of DEL/INS/DUP/INV/BND at ~1 SV per 100 kb plus background noise
(reference: docs/userGuide/README.md:474-492). This generator builds
that shape hermetically:

  - N chromosomes of random sequence (default 8 x 16 Mb = 128 Mb);
  - two haplotypes per sample, each a segment mosaic over the reference
    (deletions, novel insertions, tandem duplications, inversions, and
    reciprocal translocations), het or hom genotypes;
  - paired-end reads drawn uniformly from each haplotype and emitted as
    the alignments a mapper would produce: full-match CIGARs inside
    segments (inverted segments flip strand), soft-clips at junction
    crossings, BWA-style SA supplementary alignments when the clipped
    remainder is >= 30 bp and uniquely placeable (the split-read
    evidence small tandem duplications depend on — their everted pairs
    fall inside the normal fragment-size range and are correctly
    rejected by the pair gate, exactly as the reference's
    AlignmentPairAnalyzer does), shadow mates inside novel insertions,
    anomalous template sizes/orientations across junctions, and a low
    rate of random mismapped-pair noise to exercise graph denoising;
  - a truth TSV (chrom, pos, type, size, genotype) and a checker that
    runs the germline workflow and scores recall / genotype accuracy /
    precision against it.

All bulk work is vectorized numpy; only junction-adjacent reads
(~0.5% at default density) take the scalar path.

Usage:
  python benchmarks/wgs_workload.py --out /tmp/wgs --chroms 8 --mb 16
  python benchmarks/wgs_workload.py --out /tmp/wgs --check [--jobs N]
  python benchmarks/wgs_workload.py --out /tmp/wgs --check --mode tumor
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from manta_tpu.io.bam import ReadBatch          # noqa: E402
from manta_tpu.io.bamwriter import BamWriter    # noqa: E402

READ_LEN = 100
# generation switches to external-merge (bounded-memory) BAM writing
# above this expected read count; tests lower it to cover the path
SPILL_THRESHOLD_READS = 30_000_000
# mutable module-level fragment-size model: --frag-mean/--frag-sd
# override for wide-insert (FFPE-like) library shapes, whose wide
# breakend CIs drive large contig-alignment windows in phase 2
FRAG_MEAN, FRAG_SD, FRAG_LO, FRAG_HI = 300, 30, 200, 450
MIN_ANCHOR = 20          # min aligned bases to anchor a junction read
BASES = np.frombuffer(b"ACGT", np.uint8)
_RC = np.zeros(256, np.uint8)
for _a, _b in zip(b"ACGTN", b"TGCAN"):
    _RC[_a] = _b


def revcomp(a: np.ndarray) -> np.ndarray:
    return _RC[a[::-1]]


# --------------------------------------------------------------- genome

def make_truth(rng, chrom_lens, spacing_kb=100, n_transloc=2):
    """Plan the SV truth set. Returns (svs, translocs).

    svs: list of dict(chrom_i, pos, type, size, gt, ins_seq)
    translocs: list of dict(chrom_a, pos_a, chrom_b, pos_b, gt)
    """
    svs = []
    types = ["DEL", "INS", "DUP", "INV"]
    probs = [0.35, 0.25, 0.20, 0.20]
    for ci, clen in enumerate(chrom_lens):
        spacing = spacing_kb * 1000
        pos = 20000
        while pos < clen - 30000:
            p = pos + int(rng.integers(0, spacing // 2))
            typ = rng.choice(types, p=probs)
            # log-uniform sizes, 100 b .. 8 kb
            size = int(np.exp(rng.uniform(np.log(100), np.log(8000))))
            gt = "het" if rng.random() < 0.6 else "hom"
            ins_seq = BASES[rng.integers(0, 4, size)] if typ == "INS" \
                else None
            if p + size < clen - 25000:
                svs.append(dict(chrom_i=ci, pos=p, type=typ, size=size,
                                gt=gt, ins_seq=ins_seq))
            pos += spacing + (size if typ != "INS" else 0)
    translocs = []
    nc = len(chrom_lens)
    for k in range(min(n_transloc, nc // 2)):
        ca, cb = 2 * k, 2 * k + 1
        pa = int(chrom_lens[ca] * rng.uniform(0.35, 0.65))
        pb = int(chrom_lens[cb] * rng.uniform(0.35, 0.65))
        translocs.append(dict(chrom_a=ca, pos_a=pa, chrom_b=cb, pos_b=pb,
                              gt="het"))
    return svs, translocs


class DerivedChrom:
    """One haplotype chromosome: a mosaic of reference segments and
    novel sequence. Segments: (hap_beg, tid, ref_beg, ref_end, strand)
    with tid = -1 for novel segments (ref_beg indexes novel_blob)."""

    def __init__(self):
        self.segs = []              # rows appended then frozen to arrays
        self.novel = []             # list of uint8 arrays
        self._hap_len = 0

    def add_ref(self, tid, beg, end, strand=1):
        if end <= beg:
            return
        self.segs.append((self._hap_len, tid, beg, end, strand))
        self._hap_len += end - beg

    def add_novel(self, seq):
        off = sum(len(s) for s in self.novel)
        self.novel.append(seq)
        self.segs.append((self._hap_len, -1, off, off + len(seq), 1))
        self._hap_len += len(seq)

    def freeze(self, ref_seqs):
        self.hap_beg = np.array([s[0] for s in self.segs], np.int64)
        self.tid = np.array([s[1] for s in self.segs], np.int32)
        self.ref_beg = np.array([s[2] for s in self.segs], np.int64)
        self.ref_end = np.array([s[3] for s in self.segs], np.int64)
        self.strand = np.array([s[4] for s in self.segs], np.int8)
        self.hap_len = self._hap_len
        novel_blob = (np.concatenate(self.novel) if self.novel
                      else np.zeros(0, np.uint8))
        parts = []
        for _, tid, beg, end, strand in self.segs:
            chunk = (novel_blob[beg:end] if tid < 0
                     else ref_seqs[tid][beg:end])
            parts.append(revcomp(chunk) if strand < 0 else chunk)
        self.seq = (np.concatenate(parts) if parts
                    else np.zeros(0, np.uint8))
        return self


def build_haplotypes(ref_seqs, chrom_lens, svs, translocs):
    """Two haplotypes as lists of DerivedChrom."""
    haps = []
    for h in (0, 1):
        # chromosome arms after translocation surgery (het: hap 0 only)
        # derived chrom plan: per source chrom, the (tid, cut) rewiring
        joined = {}           # ci -> (tail_tid, tail_cut) after cut
        cuts = {}             # ci -> cut position (own arm ends there)
        for tr in translocs:
            if tr["gt"] == "het" and h != 0:
                continue
            cuts[tr["chrom_a"]] = tr["pos_a"]
            cuts[tr["chrom_b"]] = tr["pos_b"]
            joined[tr["chrom_a"]] = (tr["chrom_b"], tr["pos_b"])
            joined[tr["chrom_b"]] = (tr["chrom_a"], tr["pos_a"])

        per_chrom_svs = {}
        for sv in svs:
            if sv["gt"] == "het" and h != 0:
                continue
            per_chrom_svs.setdefault(sv["chrom_i"], []).append(sv)

        def emit_ref_span(dc, tid, beg, end):
            """Append [beg,end) of source chrom tid, applying its SVs."""
            cursor = beg
            for sv in sorted(per_chrom_svs.get(tid, []),
                             key=lambda s: s["pos"]):
                p, size = sv["pos"], sv["size"]
                if p < beg or p + size > end:
                    continue
                typ = sv["type"]
                if typ == "DEL":
                    dc.add_ref(tid, cursor, p)
                    cursor = p + size
                elif typ == "INS":
                    dc.add_ref(tid, cursor, p)
                    dc.add_novel(sv["ins_seq"])
                    cursor = p
                elif typ == "DUP":
                    dc.add_ref(tid, cursor, p + size)
                    dc.add_ref(tid, p, p + size)      # second copy
                    cursor = p + size
                elif typ == "INV":
                    dc.add_ref(tid, cursor, p)
                    dc.add_ref(tid, p, p + size, strand=-1)
                    cursor = p + size
            dc.add_ref(tid, cursor, end)

        out = []
        for ci, clen in enumerate(chrom_lens):
            dc = DerivedChrom()
            if ci in cuts:
                emit_ref_span(dc, ci, 0, cuts[ci])
                jt, jc = joined[ci]
                emit_ref_span(dc, jt, jc, chrom_lens[jt])
            else:
                emit_ref_span(dc, ci, 0, clen)
            out.append(dc.freeze(ref_seqs))
        haps.append(out)
    return haps


# -------------------------------------------------------------- repeats

def apply_repeat_structure(rng, ref_seqs, svs, min_anchored: int = 0):
    """--repeats: write adversarial repeat content into the reference
    BEFORE haplotype construction (carried SVs inherit it), returning
    family annotations for the read-level mismap model and the checker.

    Reference-motivated content (the graph's complexity aborts exist
    because of exactly this — SVLocusSetOptions.hpp:50-54; the
    flank-uniqueness contig filter because of this — methods.tex:406):
      - tandem satellite arrays (unit 5-40 bp, 2-8 kb), a third written
        AROUND a planted SV so its junction sits inside the array;
      - dispersed segmental-duplication families: 5-15 kb donor copied
        at ~1% divergence to 2-4 acceptor sites, cross-chrom allowed;
      - low-complexity homopolymer / dinucleotide runs (0.2-1 kb)."""
    families = []
    nC = len(ref_seqs)
    lens = [len(s) for s in ref_seqs]

    def rand_pos(tid, width):
        return int(rng.integers(width, lens[tid] - 2 * width))

    n_tand = max(2, sum(lens) // 2_000_000)
    anchors = [sv for sv in svs if sv["type"] in ("DEL", "DUP", "INS")]
    rng.shuffle(anchors)
    n_anchored = max(1, n_tand // 3) if anchors else 0
    if min_anchored and anchors:
        # statistical-power mode (--repeat-anchors): plant at least this
        # many SV junctions inside satellite arrays so repeat-proximal
        # recall is measured on n>=100, not anecdotes (round-5 verdict)
        n_anchored = min(max(n_anchored, min_anchored), len(anchors))
        n_tand = max(n_tand, n_anchored * 3 // 2)
    for k in range(n_tand):
        unit = int(rng.integers(5, 41))
        span = int(rng.integers(2000, 8001))
        if k < n_anchored and k < len(anchors):
            sv = anchors[k]
            tid = sv["chrom_i"]
            beg = max(1000, sv["pos"] - span // 2)
        else:
            tid = int(rng.integers(0, nC))
            beg = rand_pos(tid, span + 1000)
        end = min(beg + span, lens[tid] - 1000)
        motif = BASES[rng.integers(0, 4, unit)]
        ref_seqs[tid][beg:end] = np.tile(
            motif, -(-(end - beg) // unit))[:end - beg]
        families.append(dict(type="tandem", copies=[(tid, beg, end)],
                             unit=unit))

    for _ in range(max(2, sum(lens) // 3_000_000)):
        tid = int(rng.integers(0, nC))
        span = int(rng.integers(200, 1001))
        beg = rand_pos(tid, span + 1000)
        end = beg + span
        if rng.random() < 0.5:
            ref_seqs[tid][beg:end] = BASES[int(rng.integers(0, 4))]
        else:
            ref_seqs[tid][beg:end] = np.tile(
                BASES[rng.integers(0, 4, 2)], span // 2 + 1)[:span]
        families.append(dict(type="lowc", copies=[(tid, beg, end)],
                             unit=1))

    for _ in range(max(1, sum(lens) // 8_000_000)):
        dlen = int(rng.integers(5000, 15001))
        dt = int(rng.integers(0, nC))
        db = rand_pos(dt, dlen + 2000)
        donor = ref_seqs[dt][db:db + dlen].copy()
        copies = [(dt, db, db + dlen)]
        for _c in range(int(rng.integers(1, 4))):
            at = int(rng.integers(0, nC))
            ab = rand_pos(at, dlen + 2000)
            cp = donor.copy()
            ndiv = rng.binomial(dlen, 0.01)
            ai = rng.integers(0, dlen, ndiv)
            cp[ai] = BASES[(rng.integers(1, 4, ndiv) +
                            np.searchsorted(BASES, cp[ai])) % 4]
            ref_seqs[at][ab:ab + dlen] = cp
            copies.append((at, ab, ab + dlen))
        families.append(dict(type="segdup", copies=copies, unit=0))
    return families


class MismapModel:
    """Read-level mapper-confusion model over repeat families.

    A real aligner, not the simulator's omniscient placement, is what
    turns repeats into graph pressure: reads from one segdup copy map
    confidently into another (anomalous pairs = dense noise edges),
    and reads inside satellite/low-complexity arrays come back MAPQ 0
    or shifted by whole repeat units. This applies those effects
    vectorially to mapped (tid, pos) read columns."""

    def __init__(self, families, n_tids,
                 p_move=0.08, p_move_hi_mapq=0.3, p_mq0=0.4,
                 p_jit=0.3, p_attract=0.004):
        self.p_move = p_move
        self.p_move_hi = p_move_hi_mapq
        self.p_mq0 = p_mq0
        self.p_jit = p_jit
        # satellite attractor: reads from unassembled repeat copies
        # genome-wide pile into the few assembled array copies with
        # scattered mates — the real-data source of the graph's
        # noise-node pressure (SVLocusSet.cpp:536+ abort machinery)
        self.p_attract = p_attract
        self.arrays = [(t, b, e) for fam in families
                       if fam["type"] == "tandem"
                       for (t, b, e) in fam["copies"]]
        sd = {t: [] for t in range(n_tids)}
        rp = {t: [] for t in range(n_tids)}
        self.fam_copies = []
        for fi, fam in enumerate(families):
            if fam["type"] == "segdup":
                self.fam_copies.append(np.array(fam["copies"], np.int64))
                for ci, (t, b, e) in enumerate(fam["copies"]):
                    sd[t].append((b, e, len(self.fam_copies) - 1, ci))
            else:
                for (t, b, e) in fam["copies"]:
                    rp[t].append((b, e, max(fam["unit"], 1)))
        self.sd = {t: np.array(sorted(v), np.int64).reshape(-1, 4)
                   for t, v in sd.items() if v}
        self.rp = {t: np.array(sorted(v), np.int64).reshape(-1, 3)
                   for t, v in rp.items() if v}

    def _inside(self, table, t, p, L):
        """(row_index, inside_mask) for reads fully inside an interval."""
        idx = np.full(len(p), -1, np.int64)
        for tid, arr in table.items():
            m = t == tid
            if not m.any():
                continue
            j = np.searchsorted(arr[:, 0], p[m], "right") - 1
            ok = (j >= 0)
            jj = np.clip(j, 0, len(arr) - 1)
            ok &= (p[m] >= arr[jj, 0]) & (p[m] + L <= arr[jj, 1])
            sub = np.where(ok, jj, -1)
            idx[m] = sub
        return idx

    def apply(self, rng, t, p):
        """Returns (t', p', mapq) for mapped read columns."""
        L = READ_LEN
        t = t.astype(np.int64).copy()
        p = p.copy()
        mapq = np.full(len(p), 60, np.uint8)

        # segdup teleportation (masks against the PRE-move columns: a
        # read teleported into tid X must not be re-selected by X's
        # interval table)
        t0, p0 = t.copy(), p.copy()
        idx = self._inside(self.sd, t0, p0, L)
        hit = idx >= 0
        if hit.any():
            move = hit & (rng.random(len(p)) < self.p_move)
            for tid, arr in self.sd.items():
                m = move & (t0 == tid)
                if not m.any():
                    continue
                rows = arr[idx[m]]
                off = p0[m] - rows[:, 0]
                fam = rows[:, 2]
                cur = rows[:, 3]
                # pick a random OTHER copy per read
                new_t = np.empty(int(m.sum()), np.int64)
                new_p = np.empty(int(m.sum()), np.int64)
                for u, (f, c, o) in enumerate(zip(fam, cur, off)):
                    cps = self.fam_copies[int(f)]
                    j = int(rng.integers(0, len(cps) - 1))
                    if j >= int(c):
                        j += 1
                    new_t[u] = cps[j, 0]
                    new_p[u] = cps[j, 1] + int(o)
                t[m] = new_t
                p[m] = new_p
            # confident-wrong vs low-mapq mismaps
            lowq = move & (rng.random(len(p)) >= self.p_move_hi)
            mapq[lowq] = rng.integers(3, 30, int(lowq.sum()))
            # unmoved in-segdup reads: MAPQ0 fraction
            mq0 = hit & ~move & (rng.random(len(p)) < self.p_mq0)
            mapq[mq0] = 0

        # satellite / low-complexity: MAPQ0 + unit jitter
        idx = self._inside(self.rp, t, p, L)
        hit = idx >= 0
        if hit.any():
            mq0 = hit & (rng.random(len(p)) < self.p_mq0)
            mapq[mq0] = 0
            jit = hit & (rng.random(len(p)) < self.p_jit)
            for tid, arr in self.rp.items():
                m = jit & (t == tid)
                if not m.any():
                    continue
                rows = arr[idx[m]]
                unit = rows[:, 2]
                k = rng.integers(1, 4, int(m.sum())) * \
                    np.where(rng.random(int(m.sum())) < 0.5, -1, 1)
                np2 = p[m] + k * unit
                np2 = np.clip(np2, rows[:, 0], rows[:, 1] - L)
                p[m] = np2

        # attractor: non-repeat reads teleported INTO a satellite array
        # at a random offset; half keep confident MAPQ (the graph-edge
        # noise), half come back MAPQ0
        if self.arrays and self.p_attract > 0:
            att = (idx < 0) & (rng.random(len(p)) < self.p_attract)
            na = int(att.sum())
            if na:
                ai = rng.integers(0, len(self.arrays), na)
                t_att = np.empty(na, np.int64)
                p_att = np.empty(na, np.int64)
                for u, a in enumerate(ai):
                    at, ab, ae = self.arrays[int(a)]
                    t_att[u] = at
                    p_att[u] = int(rng.integers(ab, max(ab + 1,
                                                        ae - L)))
                t[att] = t_att
                p[att] = p_att
                mq_att = np.where(rng.random(na) < 0.5, 60,
                                  rng.integers(0, 20, na))
                mapq[att] = mq_att.astype(np.uint8)
        return t, p, mapq


# ------------------------------------------------------------ simulation

def _map_regular(dc, seg, start, L):
    """(tid, refpos, refstrand) for reads fully inside ref segment."""
    off = start - dc.hap_beg[seg]
    fwd = dc.strand[seg] > 0
    pos = np.where(fwd, dc.ref_beg[seg] + off,
                   dc.ref_end[seg] - off - L)
    return dc.tid[seg], pos.astype(np.int64), ~fwd


def _names(prefix: bytes, ids: np.ndarray):
    """Flat name blob + offsets for b'{prefix}{id}' names."""
    s = np.char.add(prefix.decode(), ids.astype("U10"))
    joined = "".join(s.tolist()).encode()
    lens = np.char.str_len(s).astype(np.int64)
    off = np.zeros(len(ids) + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    return np.frombuffer(joined, np.uint8), off


def _bulk_batch(ref_seqs, tid1, pos1, rev1, tid2, pos2, rev2,
                frag_ids, err_rate, rng, mapq1=None, mapq2=None):
    """Vectorized ReadBatch for regular (full-match) pairs."""
    n = len(tid1)
    L = READ_LEN
    tid = np.empty(2 * n, np.int32)
    pos = np.empty(2 * n, np.int64)
    rev = np.empty(2 * n, bool)
    tid[0::2], tid[1::2] = tid1, tid2
    pos[0::2], pos[1::2] = pos1, pos2
    rev[0::2], rev[1::2] = rev1, rev2

    # flags
    flag = np.full(2 * n, 0x1, np.uint16)
    flag[0::2] |= 0x40
    flag[1::2] |= 0x80
    flag |= np.where(rev, 0x10, 0).astype(np.uint16)
    mrev = np.empty(2 * n, bool)
    mrev[0::2], mrev[1::2] = rev[1::2], rev[0::2]
    flag |= np.where(mrev, 0x20, 0).astype(np.uint16)

    # tlen (leftmost-forward convention) + proper-pair flag
    same = tid1 == tid2
    lo = np.minimum(pos1, pos2)
    hi = np.maximum(pos1, pos2) + L
    span = np.where(same, hi - lo, 0)
    s1 = np.where(same, np.where(pos1 <= pos2, span, -span), 0)
    # FR innie: leftmost mate forward, rightmost reverse
    left_rev = np.where(pos1 <= pos2, rev1, rev2)
    right_rev = np.where(pos1 <= pos2, rev2, rev1)
    proper = same & (~left_rev) & right_rev & (span < 1200) & (span >= L)
    tlen = np.empty(2 * n, np.int32)
    tlen[0::2], tlen[1::2] = s1, -s1
    flag |= np.where(np.repeat(proper, 2), 0x2, 0).astype(np.uint16)

    # seq gather: ref-forward bases per read, chunked per chromosome
    seq = np.empty(2 * n * L, np.uint8).reshape(2 * n, L)
    for t in np.unique(tid):
        m = tid == t
        seq[m] = ref_seqs[t][pos[m, None] + np.arange(L)[None, :]]
    if err_rate > 0:
        nerr = rng.binomial(2 * n * L, err_rate)
        if nerr:
            flat = seq.reshape(-1)
            at = rng.integers(0, flat.size, nerr)
            flat[at] = BASES[(rng.integers(1, 4, nerr) +
                              np.searchsorted(BASES, flat[at])) % 4]

    name, name_off = _names(b"w", np.repeat(frag_ids, 2))
    k = np.arange(2 * n, dtype=np.int64)
    nref = np.empty(2 * n, np.int32)
    npos = np.empty(2 * n, np.int64)
    nref[0::2], nref[1::2] = tid2, tid1
    npos[0::2], npos[1::2] = pos2, pos1
    mq = np.full(2 * n, 60, np.uint8)
    if mapq1 is not None:
        mq[0::2] = mapq1
    if mapq2 is not None:
        mq[1::2] = mapq2
    return ReadBatch(
        n=2 * n, refid=tid, pos=pos.astype(np.int32),
        mapq=mq, flag=flag,
        next_refid=nref, next_pos=npos.astype(np.int32), tlen=tlen,
        cigar_off=np.arange(2 * n + 1, dtype=np.int64),
        cigar=np.full(2 * n, (L << 4) | 0, np.uint32),
        seq_off=np.arange(2 * n + 1, dtype=np.int64) * L,
        seq=seq.reshape(-1),
        qual_off=np.arange(2 * n + 1, dtype=np.int64) * L,
        qual=np.full(2 * n * L, 35, np.uint8),
        name_off=name_off, name=name,
        tag_off=np.zeros(2 * n + 1, np.int64), tags=b"")


SA_MIN_CLIP = 30     # min clipped-segment length a mapper would rescue
                     # as a supplementary alignment (BWA seed scale)


def _map_piece(dc, lo, ln):
    """Map hap range [lo, lo+ln) iff it lies inside ONE reference-backed
    segment: returns (tid, ref_pos, piece_rev) or None."""
    s = int(np.searchsorted(dc.hap_beg, lo, "right") - 1)
    seg_end = (dc.hap_beg[s + 1] if s + 1 < len(dc.hap_beg)
               else dc.hap_len)
    if dc.tid[s] < 0 or lo + ln > seg_end:
        return None
    off = lo - dc.hap_beg[s]
    if dc.strand[s] > 0:
        return int(dc.tid[s]), int(dc.ref_beg[s] + off), False
    return int(dc.tid[s]), int(dc.ref_end[s] - off - ln), True


def _map_irregular(dc, start):
    """Scalar mapping of one read at hap pos `start`: returns
    (tid, pos, cigar_str, rev, stored_seq, supp) or None if
    unmappable. Anchors on whichever end has >= MIN_ANCHOR ref bases
    in one segment; the remainder is soft-clipped. When the clipped
    remainder itself maps inside one segment and is >= SA_MIN_CLIP
    long, `supp` carries (clip_lo, clip_len, tid2, pos2, piece_rev2)
    describing the supplementary alignment a mapper would emit for it
    (reference input expectation: BWA-style SA split reads,
    SVLocusScanner.cpp getSACandidatesFromRead)."""
    L = READ_LEN
    sa = int(np.searchsorted(dc.hap_beg, start, "right") - 1)
    sb = int(np.searchsorted(dc.hap_beg, start + L - 1, "right") - 1)
    hap_seq = dc.seq[start:start + L]

    def seg_end(s):
        return (dc.hap_beg[s + 1] if s + 1 < len(dc.hap_beg)
                else dc.hap_len)

    def supp_of(clip_lo, clip_len):
        if clip_len < SA_MIN_CLIP:
            return None
        m = _map_piece(dc, clip_lo, clip_len)
        if m is None:
            return None
        return (clip_lo - start, clip_len) + m

    # left anchor
    left_len = min(seg_end(sa), start + L) - start
    if dc.tid[sa] >= 0 and left_len >= MIN_ANCHOR:
        off = start - dc.hap_beg[sa]
        clip = L - left_len
        supp = supp_of(start + left_len, clip) if clip else None
        if dc.strand[sa] > 0:
            cig = f"{left_len}M{clip}S" if clip else f"{L}M"
            return (int(dc.tid[sa]), int(dc.ref_beg[sa] + off), cig,
                    False, hap_seq, supp)
        cig = f"{clip}S{left_len}M" if clip else f"{L}M"
        return (int(dc.tid[sa]),
                int(dc.ref_end[sa] - off - left_len), cig,
                True, revcomp(hap_seq), supp)
    # right anchor
    right_len = start + L - max(dc.hap_beg[sb], start)
    if dc.tid[sb] >= 0 and right_len >= MIN_ANCHOR:
        clip = L - right_len
        supp = supp_of(start, clip) if clip else None
        if dc.strand[sb] > 0:
            cig = f"{clip}S{right_len}M" if clip else f"{L}M"
            return (int(dc.tid[sb]), int(dc.ref_beg[sb] +
                                         (start + L - dc.hap_beg[sb]) -
                                         right_len), cig, False, hap_seq,
                    supp)
        off_end = start + L - dc.hap_beg[sb]
        cig = f"{right_len}M{clip}S" if clip else f"{L}M"
        return (int(dc.tid[sb]),
                int(dc.ref_end[sb] - off_end), cig,
                True, revcomp(hap_seq), supp)
    return None


def _irregular_reads(dc, starts1, starts2, frag_ids):
    """Scalar path: read dicts for fragments near junctions."""
    from manta_tpu.core import cigar as cg
    rows = []
    for p1, p2, fid in zip(starts1.tolist(), starts2.tolist(),
                           frag_ids.tolist()):
        m1 = _map_irregular(dc, p1)
        m2 = _map_irregular(dc, p2)
        if m1 is None and m2 is None:
            continue
        name = f"w{fid}"
        recs = []
        for mi, (m, other, first) in enumerate(
                (((m1), m2, True), ((m2), m1, False))):
            hap_start = p1 if first else p2
            phys_rev = not first          # r2 sequenced hap-reverse
            if m is None:                 # shadow at mate
                o_tid, o_pos = other[0], other[1]
                seq = dc.seq[hap_start:hap_start + READ_LEN]
                # mappers store an unmapped read's RAW sequenced bases:
                # the physically-reverse mate (r2 of an FR pair) carries
                # the reverse complement of the haplotype-forward
                # segment. Manta's assembler re-normalizes via the
                # anchor's strand (SVCandidateAssembler shadow
                # reversal), so emitting hap-forward here poisoned
                # insertion assembly with RC'd k-mers (round-5 fix).
                if phys_rev:
                    seq = revcomp(seq)
                recs.append(dict(refid=o_tid, pos=o_pos, mapq=0,
                                 cigar="", seq=seq,
                                 flag=0x1 | 0x4 | (0x40 if first else 0x80),
                                 rev=False, next_refid=o_tid,
                                 next_pos=o_pos, name=name))
                continue
            tid, pos, cig, seg_rev, seq, supp = m
            rev = seg_rev ^ phys_rev
            # stored seq orientation: ref-forward. m returns seq for a
            # hap-forward read; physical r2 reverse does not change the
            # ref-forward stored bases.
            rec = dict(refid=tid, pos=pos, mapq=60, cigar=cig,
                       seq=seq, rev=rev,
                       flag=0x1 | (0x40 if first else 0x80) |
                       (0x10 if rev else 0), name=name)
            if supp is not None:
                # a mapper rescues the clipped remainder as a
                # supplementary alignment; emit the SA tag pair + the
                # 0x800 record like BWA would
                clip_lo, cl, tid2, pos2, piece_rev2 = supp
                L = READ_LEN
                pre, post = clip_lo, L - clip_lo - cl
                supp_rev = piece_rev2 ^ phys_rev
                if not piece_rev2:
                    scig = (f"{pre}S" if pre else "") + f"{cl}M" + \
                        (f"{post}S" if post else "")
                    sseq = dc.seq[hap_start:hap_start + L]
                else:
                    scig = (f"{post}S" if post else "") + f"{cl}M" + \
                        (f"{pre}S" if pre else "")
                    sseq = revcomp(dc.seq[hap_start:hap_start + L])
                sa_of_supp = (f"{dc.names[tid2]},{pos2 + 1},"
                              f"{'-' if supp_rev else '+'},{scig},60,0;")
                sa_of_prim = (f"{dc.names[tid]},{pos + 1},"
                              f"{'-' if rev else '+'},{cig},60,0;")
                rec["tags"] = b"SAZ" + sa_of_supp.encode() + b"\x00"
                rec["supp"] = dict(
                    refid=tid2, pos=pos2, mapq=60, cigar=scig,
                    seq=sseq, rev=supp_rev,
                    flag=0x1 | 0x800 | (0x40 if first else 0x80) |
                    (0x10 if supp_rev else 0), name=name,
                    tags=b"SAZ" + sa_of_prim.encode() + b"\x00")
            recs.append(rec)
        # cross-link mates
        if len(recs) == 2:
            a, b = recs
            a["next_refid"], a["next_pos"] = b["refid"], b["pos"]
            b["next_refid"], b["next_pos"] = a["refid"], a["pos"]
            a["flag"] |= 0x20 if (b["flag"] & 0x10) else 0
            b["flag"] |= 0x20 if (a["flag"] & 0x10) else 0
            if (a["flag"] | b["flag"]) & 0x4:
                a["flag"] |= 0x8 if (b["flag"] & 0x4) else 0
                b["flag"] |= 0x8 if (a["flag"] & 0x4) else 0
                a["tlen"] = b["tlen"] = 0
            elif a["refid"] == b["refid"]:
                # aligned span from cigar
                def span(r):
                    ops, lens = cg.string_to_arrays(r["cigar"])
                    return int(lens[(ops == 0) | (ops == 2)].sum())
                lo = min(a["pos"], b["pos"])
                hi = max(a["pos"] + span(a), b["pos"] + span(b))
                s = hi - lo
                first_left = a["pos"] <= b["pos"]
                a["tlen"] = s if first_left else -s
                b["tlen"] = -a["tlen"]
            else:
                a["tlen"] = b["tlen"] = 0
        supps = []
        for r in recs:
            s = r.pop("supp", None)
            if s is not None:
                # supplementary carries the primary's mate linkage
                s["next_refid"] = r.get("next_refid", -1)
                s["next_pos"] = r.get("next_pos", -1)
                s["flag"] |= r["flag"] & (0x8 | 0x20)
                s["tlen"] = r.get("tlen", 0)
                supps.append(s)
        rows.extend(recs)
        rows.extend(supps)
    return rows


def _rows_to_batch(rows):
    from manta_tpu.core import cigar as cg
    n = len(rows)
    if n == 0:
        return None
    refid = np.zeros(n, np.int32); pos = np.zeros(n, np.int32)
    mapq = np.zeros(n, np.uint8); flag = np.zeros(n, np.uint16)
    nref = np.zeros(n, np.int32); npos = np.zeros(n, np.int32)
    tlen = np.zeros(n, np.int32)
    cig_off = np.zeros(n + 1, np.int64)
    seq_off = np.zeros(n + 1, np.int64)
    name_off = np.zeros(n + 1, np.int64)
    tag_off = np.zeros(n + 1, np.int64)
    cigs, seqs, names = [], [], []
    tag_blobs = []
    for i, r in enumerate(rows):
        refid[i] = r["refid"]; pos[i] = r["pos"]
        mapq[i] = r["mapq"]; flag[i] = r["flag"]
        nref[i] = r.get("next_refid", -1)
        npos[i] = r.get("next_pos", -1)
        tlen[i] = r.get("tlen", 0)
        tag_blobs.append(r.get("tags", b""))
        tag_off[i + 1] = tag_off[i] + len(tag_blobs[-1])
        if r["cigar"]:
            ops, lens = cg.string_to_arrays(r["cigar"])
            cigs.append((lens.astype(np.uint32) << 4) |
                        ops.astype(np.uint32))
        else:
            cigs.append(np.zeros(0, np.uint32))
        seqs.append(np.asarray(r["seq"], np.uint8))
        names.append(np.frombuffer(r["name"].encode(), np.uint8))
        cig_off[i + 1] = cig_off[i] + len(cigs[-1])
        seq_off[i + 1] = seq_off[i] + len(seqs[-1])
        name_off[i + 1] = name_off[i] + len(names[-1])
    seq = np.concatenate(seqs) if seqs else np.zeros(0, np.uint8)
    return ReadBatch(
        n=n, refid=refid, pos=pos, mapq=mapq, flag=flag,
        next_refid=nref, next_pos=npos, tlen=tlen,
        cigar_off=cig_off,
        cigar=(np.concatenate(cigs) if cigs else np.zeros(0, np.uint32)),
        seq_off=seq_off, seq=seq,
        qual_off=seq_off.copy(), qual=np.full(len(seq), 35, np.uint8),
        name_off=name_off,
        name=(np.concatenate(names) if names else np.zeros(0, np.uint8)),
        tag_off=tag_off, tags=b"".join(tag_blobs))


def simulate(rng, ref_seqs, haps, writer, depth, err_rate=0.001,
             noise_rate=1e-4, chunk_frags=400_000, log=print,
             mismap=None):
    """Stream reads from both haplotypes into `writer`."""
    next_fid = 0
    for h, dchroms in enumerate(haps):
        for dc in dchroms:
            if dc.hap_len < FRAG_HI + 2:
                continue
            n_frags = int(depth / 2 * dc.hap_len / (2 * READ_LEN))
            done = 0
            while done < n_frags:
                n = min(chunk_frags, n_frags - done)
                done += n
                frag = rng.normal(FRAG_MEAN, FRAG_SD, n)
                frag = np.clip(frag, FRAG_LO, FRAG_HI).astype(np.int64)
                p1 = rng.integers(0, dc.hap_len - frag - 1)
                p2 = p1 + frag - READ_LEN
                fids = np.arange(next_fid, next_fid + n)
                next_fid += n

                sa1 = np.searchsorted(dc.hap_beg, p1, "right") - 1
                sb1 = np.searchsorted(dc.hap_beg, p1 + READ_LEN - 1,
                                      "right") - 1
                sa2 = np.searchsorted(dc.hap_beg, p2, "right") - 1
                sb2 = np.searchsorted(dc.hap_beg, p2 + READ_LEN - 1,
                                      "right") - 1
                reg = ((sa1 == sb1) & (sa2 == sb2) &
                       (dc.tid[sa1] >= 0) & (dc.tid[sa2] >= 0))

                # noise: a small fraction of regular pairs get the
                # mate teleported (mismapping), making sparse
                # anomalous-pair noise for the denoiser
                noise = reg & (rng.random(n) < noise_rate)
                regn = reg & ~noise

                t1, q1, r1 = _map_regular(dc, sa1[regn], p1[regn],
                                          READ_LEN)
                t2, q2, r2 = _map_regular(dc, sa2[regn], p2[regn],
                                          READ_LEN)
                # physical orientation: r1 hap-forward, r2 hap-reverse
                r1 = r1 ^ False
                r2 = ~r2
                if mismap is not None:
                    t1, q1, mq1 = mismap.apply(rng, t1, q1)
                    t2, q2, mq2 = mismap.apply(rng, t2, q2)
                else:
                    mq1 = mq2 = None
                batch = _bulk_batch(ref_seqs, t1, q1, r1, t2, q2, r2,
                                    fids[regn], err_rate, rng,
                                    mapq1=mq1, mapq2=mq2)
                writer.add_batch(batch)

                if noise.any():
                    nt1, nq1, nr1 = _map_regular(
                        dc, sa1[noise], p1[noise], READ_LEN)
                    nn = int(noise.sum())
                    nt2 = rng.integers(0, len(ref_seqs), nn)
                    nq2 = np.array(
                        [rng.integers(0, len(ref_seqs[t]) - READ_LEN)
                         for t in nt2], np.int64)
                    nr2 = rng.random(nn) < 0.5
                    nb = _bulk_batch(ref_seqs, nt1, nq1, nr1 ^ False,
                                     nt2, nq2, nr2, fids[noise],
                                     err_rate, rng)
                    writer.add_batch(nb)

                irr = ~reg
                if irr.any():
                    rows = _irregular_reads(dc, p1[irr], p2[irr],
                                            fids[irr])
                    b = _rows_to_batch(rows)
                    if b is not None:
                        writer.add_batch(b)
            log(f"hap{h} chrom len={dc.hap_len}: {n_frags} fragments")


class _BatchWriter:
    """Adapter: whole-batch adds into BamWriter's group list.

    With spill_every set, banked records are periodically flushed as
    external position-sorted runs (io/bamwriter.spill_run) so WGS-scale
    generation (hundreds of Mreads) runs in bounded memory; the caller
    merges the runs at the end (merge_runs_to_bam)."""

    def __init__(self, bw: BamWriter, spill_dir: str | None = None,
                 spill_every: int = 8_000_000):
        self.bw = bw
        self.n_reads = 0
        self._pending = 0
        self.spill_dir = spill_dir
        self.spill_every = spill_every
        self.run_prefixes: list[str] = []

    def add_batch(self, batch: ReadBatch):
        self.bw._groups.append(
            [batch, list(range(batch.n)), [b""] * batch.n])
        self.n_reads += batch.n
        self._pending += batch.n
        if self.spill_dir is not None and self._pending >= self.spill_every:
            self.spill()

    def spill(self):
        from manta_tpu.io.bamwriter import spill_run
        if self._pending == 0:
            return
        prefix = os.path.join(self.spill_dir,
                              f"run{len(self.run_prefixes):04d}")
        spill_run(self.bw, prefix)
        self.run_prefixes.append(prefix)
        self._pending = 0


# --------------------------------------------------------------- output

def write_fasta(path, names, seqs):
    with open(path, "w") as f, open(path + ".fai", "w") as fi:
        off = 0
        for name, seq in zip(names, seqs):
            f.write(f">{name}\n")
            off += len(name) + 2
            fi.write(f"{name}\t{len(seq)}\t{off}\t70\t71\n")
            b = bytes(seq)
            for i in range(0, len(b), 70):
                f.write(b[i:i + 70].decode() + "\n")
            off += len(b) + (len(b) + 69) // 70


def generate(args):
    global FRAG_MEAN, FRAG_SD, FRAG_LO, FRAG_HI
    mean = getattr(args, "frag_mean", 300)
    sd = getattr(args, "frag_sd", 30)
    FRAG_MEAN, FRAG_SD = mean, sd
    FRAG_LO, FRAG_HI = max(READ_LEN + 10, mean - 5 * sd), mean + 5 * sd
    rng = np.random.default_rng(args.seed)
    nC = args.chroms
    chrom_lens = [args.mb * 1_000_000] * nC
    names = [f"chr{i + 1}" for i in range(nC)]
    t0 = time.time()
    ref_seqs = [BASES[rng.integers(0, 4, L)] for L in chrom_lens]
    print(f"[{time.time() - t0:6.1f}s] reference built "
          f"({sum(chrom_lens) / 1e6:.0f} Mb)")

    svs, translocs = make_truth(rng, chrom_lens,
                                spacing_kb=args.spacing_kb,
                                n_transloc=args.translocs)
    n_smp = args.samples
    # per-sample genotypes over the shared truth set: sample 0 keeps
    # the planned genotype (so every SV has at least one carrier),
    # further samples re-roll ref/het/hom independently — the joint
    # germline shape of the reference's up-to-~10-diploid-sample mode
    # (reference: docs/userGuide/README.md:50-69)
    for sv in svs:
        sv["gts"] = [sv["gt"]] + [
            ("ref", "het", "hom")[rng.choice(3, p=(0.35, 0.40, 0.25))]
            for _ in range(n_smp - 1)]
    for tr in translocs:
        tr["gts"] = [tr["gt"]] + [
            ("ref", "het")[rng.choice(2, p=(0.5, 0.5))]
            for _ in range(n_smp - 1)]
    with open(args.out + ".truth.tsv", "w") as f:
        f.write("chrom\tpos\ttype\tsize\tgt\n")
        for sv in svs:
            f.write(f"{names[sv['chrom_i']]}\t{sv['pos']}\t{sv['type']}"
                    f"\t{sv['size']}\t{','.join(sv['gts'])}\n")
        for tr in translocs:
            f.write(f"{names[tr['chrom_a']]}\t{tr['pos_a']}\tBND\t0\t"
                    f"{','.join(tr['gts'])}:{names[tr['chrom_b']]}:"
                    f"{tr['pos_b']}\n")
    print(f"[{time.time() - t0:6.1f}s] truth: {len(svs)} SVs + "
          f"{len(translocs)} translocations x {n_smp} sample(s)")

    mismap = None
    if getattr(args, "repeats", False):
        fams = apply_repeat_structure(
            rng, ref_seqs, svs,
            min_anchored=getattr(args, "repeat_anchors", 0))
        with open(args.out + ".repeats.tsv", "w") as f:
            f.write("type\tunit\tcopies\n")
            for fam in fams:
                cps = ";".join(f"{names[t]}:{b}-{e}"
                               for t, b, e in fam["copies"])
                f.write(f"{fam['type']}\t{fam['unit']}\t{cps}\n")
        mismap = MismapModel(fams, nC)
        n_sd = sum(1 for x in fams if x["type"] == "segdup")
        print(f"[{time.time() - t0:6.1f}s] repeats: {len(fams)} "
              f"families ({n_sd} segdup)")

    write_fasta(args.out + ".fa", names, ref_seqs)
    for smp in range(n_smp):
        svs_k = [dict(sv, gt=sv["gts"][smp]) for sv in svs
                 if sv["gts"][smp] != "ref"]
        tr_k = [dict(tr, gt=tr["gts"][smp]) for tr in translocs
                if tr["gts"][smp] != "ref"]
        haps = build_haplotypes(ref_seqs, chrom_lens, svs_k, tr_k)
        for dchroms in haps:
            for dc in dchroms:
                dc.names = names    # for SA-tag rname fields
        print(f"[{time.time() - t0:6.1f}s] sample {smp}: haplotypes "
              f"built ({len(svs_k)} carried SVs)")
        bam = args.out + (".bam" if n_smp == 1 else f".s{smp}.bam")
        header = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
            f"@SQ\tSN:{n}\tLN:{L}\n" for n, L in zip(names, chrom_lens)
        ) + f"@RG\tID:rg1\tSM:WGS{smp + 1}\n"
        bw = BamWriter(bam, header, names, chrom_lens)
        # external-merge mode above ~30 Mreads: bounded generation
        # memory via sorted run spills + a vectorized k-way merge
        exp_reads = args.depth * sum(chrom_lens) // READ_LEN
        spill_dir = None
        if exp_reads > SPILL_THRESHOLD_READS:
            spill_dir = bam + ".runs"
            os.makedirs(spill_dir, exist_ok=True)
        w = _BatchWriter(bw, spill_dir=spill_dir)
        simulate(rng, ref_seqs, haps, w, args.depth,
                 err_rate=args.err_rate, noise_rate=args.noise_rate,
                 log=lambda m: print(f"[{time.time() - t0:6.1f}s] {m}"),
                 mismap=mismap)
        print(f"[{time.time() - t0:6.1f}s] encoding + sorting "
              f"{w.n_reads} reads")
        if spill_dir is not None:
            from manta_tpu.io.bamwriter import merge_runs_to_bam
            w.spill()
            print(f"[{time.time() - t0:6.1f}s] merging "
                  f"{len(w.run_prefixes)} runs")
            merge_runs_to_bam(w.run_prefixes, bam, header, names,
                              chrom_lens,
                              n_threads=os.cpu_count() or 2)
            import shutil
            shutil.rmtree(spill_dir, ignore_errors=True)
        else:
            bw.close()
        print(f"[{time.time() - t0:6.1f}s] wrote {bam} "
              f"({w.n_reads} reads, {args.depth}x nominal)")


# -------------------------------------------------------------- checker

def parse_vcf_records(path):
    import gzip
    import re
    op = gzip.open if path.endswith(".gz") else open
    recs = []
    with op(path, "rt") as f:
        for ln in f:
            if ln.startswith("#"):
                continue
            c = ln.rstrip("\n").split("\t")
            info = dict(kv.split("=", 1) if "=" in kv else (kv, True)
                        for kv in c[7].split(";"))
            gt = ""
            gts = []
            if len(c) > 9:
                fmt = c[8].split(":")
                if "GT" in fmt:
                    gi = fmt.index("GT")
                    gts = [col.split(":")[gi] for col in c[9:]]
                    gt = gts[0]
            svtype = info.get("SVTYPE", "")
            if not svtype:
                m = re.match(r"^Manta(\w+?):", c[2])
                svtype = m.group(1) if m else ""
            recs.append(dict(chrom=c[0], pos=int(c[1]), id=c[2],
                             ref=c[3], alt=c[4], filter=c[6],
                             info=info, gt=gt, gts=gts, svtype=svtype))
    return recs


def check(args):
    """Run the workflow on the generated data and score against the
    planted truth. --mode germline (default) scores diploidSV.vcf with
    genotypes; --mode tumor runs tumor-only calling and scores
    tumorSV.vcf (no genotypes — the tumor model emits PR/SR counts),
    giving the tumor-only pipeline a planted-truth oracle beyond the
    demo smoke test."""
    import resource
    import tempfile

    from manta_tpu.workflow.run import run_workflow
    truth = []
    with open(args.out + ".truth.tsv") as f:
        next(f)
        for ln in f:
            c = ln.rstrip("\n").split("\t")
            # BND rows pack the mate locus after the genotype list:
            # "het,ref:chr2:12345"
            gts = (c[4].split(":", 1)[0] if c[2] == "BND" and ":" in c[4]
                   else c[4]).split(",")
            truth.append(dict(chrom=c[0], pos=int(c[1]), type=c[2],
                              size=int(c[3]), gt=c[4], gts=gts))
    n_smp = len(truth[0]["gts"]) if truth else 1
    bams = ([args.out + ".bam"] if n_smp == 1 else
            [args.out + f".s{k}.bam" for k in range(n_smp)])
    run_dir = args.run_dir or tempfile.mkdtemp(prefix="wgs_")
    t0 = time.time()
    if args.mode == "tumor":
        assert n_smp == 1, "tumor mode scores a single sample"
        run_workflow([], bams, args.out + ".fa", run_dir,
                     n_jobs=args.jobs, verbose=True)
        out_vcf = "tumorSV.vcf.gz"
    else:
        run_workflow(bams, [], args.out + ".fa", run_dir,
                     n_jobs=args.jobs, verbose=True)
        out_vcf = "diploidSV.vcf.gz"
    wall = time.time() - t0
    peak_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6

    recs = parse_vcf_records(
        os.path.join(run_dir, "results", "variants", out_vcf))
    recs = [r for r in recs if r["filter"] in ("PASS", ".")]
    tol = args.tolerance

    def match(tr):
        """Find a PASS record matching truth entry tr."""
        want = {"DEL": ("DEL",), "INS": ("INS",), "DUP": ("DUP",),
                "INV": ("BND", "INV"), "BND": ("BND",)}[tr["type"]]
        hits = []
        for r in recs:
            if r["chrom"] != tr["chrom"] or r["svtype"] not in want:
                continue
            if abs(r["pos"] - tr["pos"]) <= tol:
                hits.append(r)
        return hits

    n_found = n_gt_ok = 0
    by_type = {}
    missed = []
    matched_ids = set()
    for tr in truth:
        hits = match(tr)
        bt = by_type.setdefault(tr["type"], [0, 0])
        bt[1] += 1
        if hits:
            n_found += 1
            bt[0] += 1
            matched_ids.update(h["id"] for h in hits)
            if args.mode == "tumor":
                n_gt_ok += 1
            else:
                # per-sample genotype check (joint calling: one record,
                # one GT column per sample)
                want = ["1/1" if g == "hom" else
                        ("0/1" if g == "het" else "0/0")
                        for g in tr["gts"]]
                def smp_ok(h, k):
                    cols = h["gts"] or [h["gt"]]
                    got = (cols[k] if k < len(cols) else "").replace(
                        "|", "/")
                    return got == want[k]
                if any(all(smp_ok(h, k) for k in range(len(want)))
                       for h in hits):
                    n_gt_ok += 1
        else:
            missed.append(tr)
    # FP: PASS spanning records not matching any truth breakend
    truth_pts = {(t["chrom"], t["pos"]) for t in truth}
    for t in truth:
        if t["type"] in ("DEL", "DUP", "INV"):
            truth_pts.add((t["chrom"], t["pos"] + t["size"]))
        elif t["type"] == "BND" and ":" in t["gt"]:
            _, mc, mp = t["gt"].split(":")
            truth_pts.add((mc, int(mp)))
    fp = [r for r in recs if r["id"] not in matched_ids and
          not any(r["chrom"] == c and abs(r["pos"] - p) <= tol
                  for c, p in truth_pts)]

    out = {
        "metric": "wgs_sim_recall",
        "mode": args.mode,
        "truth_n": len(truth),
        "recall": round(n_found / len(truth), 4),
        "gt_acc": round(n_gt_ok / max(n_found, 1), 4),
        "fp_records": len(fp),
        "by_type": {k: f"{v[0]}/{v[1]}" for k, v in by_type.items()},
        "wall_s": round(wall, 1),
        "peak_rss_gb": round(peak_gb, 2),
        "run_dir": run_dir,
    }

    # --repeats runs: split recall by repeat proximity, and surface the
    # graph's complexity-abort statistics (the whole point of the
    # adversarial content — SVLocusSetOptions.hpp:50-54 semantics)
    rep_path = args.out + ".repeats.tsv"
    if os.path.exists(rep_path):
        spans = []
        with open(rep_path) as f:
            next(f)
            for ln in f:
                typ, unit, cps = ln.rstrip("\n").split("\t")
                for cp in cps.split(";"):
                    ch, be = cp.split(":")
                    b, e = be.split("-")
                    spans.append((ch, int(b), int(e), typ))

        def near_repeat(tr, pad=1000):
            for (ch, b, e, typ) in spans:
                if tr["chrom"] == ch and b - pad <= tr["pos"] <= e + pad:
                    return True
            return False

        def inside_tandem(tr, margin=150):
            """Junction strictly interior to a satellite array: the SV
            degrades to a unit-remainder indel (the periodic reference
            absorbs whole units) and no unique flank exists within
            reach of the assembler — information-theoretically
            unrecoverable from local evidence, and the class the
            reference's repeat-word truncation + flank-uniqueness
            filter (methods.tex:406) protect precision against."""
            for (ch, b, e, typ) in spans:
                if typ != "tandem" or tr["chrom"] != ch:
                    continue
                if b + margin <= tr["pos"] <= e - margin and \
                        tr["pos"] + tr["size"] <= e - margin:
                    return True
            return False

        rep_truth = [t for t in truth if near_repeat(t)]
        clean_truth = [t for t in truth if not near_repeat(t)]
        rep_found = sum(1 for t in rep_truth if match(t))
        clean_found = sum(1 for t in clean_truth if match(t))
        inside = [t for t in rep_truth if inside_tandem(t)]
        edge = [t for t in rep_truth if not inside_tandem(t)]
        inside_found = sum(1 for t in inside if match(t))
        edge_found = sum(1 for t in edge if match(t))
        from manta_tpu.graph.locusgraph import SVLocusSet
        g = SVLocusSet.load(
            os.path.join(run_dir, "workspace", "svLocusGraph.npz"))
        out.update({
            "repeat_families": len({(c, b) for (c, b, _e, _t) in spans}),
            "truth_in_repeat": len(rep_truth),
            "recall_in_repeat": round(rep_found / max(len(rep_truth), 1),
                                      4),
            "truth_inside_tandem": len(inside),
            "recall_inside_tandem": round(
                inside_found / max(len(inside), 1), 4),
            "truth_repeat_edge": len(edge),
            "recall_repeat_edge": round(
                edge_found / max(len(edge), 1), 4),
            "recall_clean": round(clean_found / max(len(clean_truth), 1),
                                  4),
            "graph_highest_search_count": int(g.highest_search_count),
            "graph_highest_search_density": round(
                float(g.highest_search_density), 4),
            "graph_abort_count_hit": bool(g.is_max_search_count),
            "graph_abort_density_hit": bool(g.is_max_search_density),
        })
    print(json.dumps(out))
    if args.verbose_misses:
        for tr in missed[:40]:
            print("MISS", tr)
        for r in fp[:20]:
            print("FP", r["chrom"], r["pos"], r["svtype"], r["id"])
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--chroms", type=int, default=8)
    ap.add_argument("--mb", type=int, default=16)
    ap.add_argument("--depth", type=int, default=35)
    ap.add_argument("--spacing-kb", type=int, default=100)
    ap.add_argument("--translocs", type=int, default=2)
    ap.add_argument("--err-rate", type=float, default=0.001)
    ap.add_argument("--noise-rate", type=float, default=1e-4)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--frag-mean", type=int, default=300)
    ap.add_argument("--frag-sd", type=int, default=30)
    ap.add_argument("--repeat-anchors", type=int, default=0,
                    help="with --repeats: plant at least this many SV "
                         "junctions inside satellite arrays")
    ap.add_argument("--repeats", action="store_true",
                    help="adversarial genome content: satellite arrays,"
                         " segdup families + read mismapping, "
                         "low-complexity runs")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--mode", default="germline",
                    choices=("germline", "tumor"))
    ap.add_argument("--samples", type=int, default=1,
                    help="joint-calling sample count: each sample gets "
                         "independently re-rolled genotypes over the "
                         "same truth SV set and its own BAM "
                         "(out.s<k>.bam); 1 keeps the single-sample "
                         "layout (out.bam)")
    ap.add_argument("--jobs", type=int, default=0)
    ap.add_argument("--run-dir", default=None)
    ap.add_argument("--tolerance", type=int, default=50)
    ap.add_argument("--verbose-misses", action="store_true")
    args = ap.parse_args()
    if args.check:
        check(args)
    else:
        generate(args)


if __name__ == "__main__":
    main()
