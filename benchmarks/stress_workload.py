"""Evidence-preserving scaled stress workload for phase benchmarks.

Tiles the demo HCC1954 junction neighborhoods (chr8 10kb + chr11 25kb
windows) N times onto a synthetic two-chromosome genome, shifting both
mates of every pair per tile so spanning/split evidence stays valid.
Each tile should reproduce the demo's 6 BND junctions, giving a
correctness check (records == 6*N) along with wall-clock scaling
numbers for phase 1 and the full workflow.

Usage:
    python benchmarks/stress_workload.py --tiles 32 --out /tmp/stress \
        [--run] [-j N]
"""

from __future__ import annotations

import argparse
import copy
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

_VDEMO = os.path.join(REPO, "tests", "data", "demo")
DEMO = _VDEMO if os.path.isdir(_VDEMO) else "/root/reference/src/demo/data"
TUMOR = f"{DEMO}/G15512.HCC1954.1.COST16011_region.bam"

W8 = (107650000, 107660000)
W11 = (94970000, 94995000)
SPAN8, SPAN11 = 12000, 27000


_TAG_SIZE = {ord("A"): 1, ord("c"): 1, ord("C"): 1, ord("s"): 2,
             ord("S"): 2, ord("i"): 4, ord("I"): 4, ord("f"): 4}


def _strip_sa(b):
    """Rebuild the batch's aux blob with every SA:Z tag removed."""
    import copy as _copy
    blobs = []
    off = np.zeros(b.n + 1, np.int64)
    for i in range(b.n):
        blob = b.tags[b.tag_off[i]:b.tag_off[i + 1]]
        out = bytearray()
        j = 0
        while j + 3 <= len(blob):
            tag = blob[j:j + 2]
            typ = blob[j + 2]
            j0 = j
            j += 3
            if typ in _TAG_SIZE:
                j += _TAG_SIZE[typ]
            elif typ in (ord("Z"), ord("H")):
                e = blob.index(b"\x00", j)
                j = e + 1
            elif typ == ord("B"):
                st = blob[j]
                (cnt,) = np.frombuffer(blob[j + 1:j + 5], "<u4")
                j += 5 + int(cnt) * _TAG_SIZE[st]
            else:
                break
            if tag != b"SA":
                out += blob[j0:j]
        blobs.append(bytes(out))
        off[i + 1] = off[i] + len(blobs[-1])
    nb = _copy.copy(b)
    nb.tag_off = off
    nb.tags = b"".join(blobs)
    return nb


def generate(tiles: int, out_prefix: str, depth_frac: float = 1.0,
             strip_sa: bool = False):
    """Tile the demo COST16011 somatic junction `tiles` times.

    depth_frac subsamples fragments per tile (the demo junction is
    ~290x; 0.2 gives a ~58x shape); strip_sa removes SA tags and
    supplementary records so candidates are pair-only/IMPRECISE and the
    refiner aligns contigs against full breakend-CI-wide reference
    windows — the high-spanning-contig shape whose phase-2 cost is
    dominated by jump-contig alignment."""
    from manta_tpu.io.bam import BamReader
    from manta_tpu.io.bamwriter import BamWriter
    from manta_tpu.io.fasta import FastaReader

    from __graft_entry__ import demo_fasta_path
    src = BamReader(TUMOR)
    fa = FastaReader(demo_fasta_path())
    t8 = src.header.name_to_tid["8"]
    t11 = src.header.name_to_tid["11"]
    b8 = src.fetch(t8, *W8)
    b11 = src.fetch(t11, *W11)

    def keep_mask(b):
        m8 = (b.next_refid == t8) & (b.next_pos >= W8[0]) & \
            (b.next_pos < W8[1])
        m11 = (b.next_refid == t11) & (b.next_pos >= W11[0]) & \
            (b.next_pos < W11[1])
        return m8 | m11 | ((b.flag & 0x8) != 0)

    b8 = b8.subset(keep_mask(b8))
    b11 = b11.subset(keep_mask(b11))

    if strip_sa:
        # drop supplementary records and strip SA tags so no split-read
        # evidence survives: candidates become pair-only and IMPRECISE
        b8 = _strip_sa(b8.subset((b8.flag & 0x800) == 0))
        b11 = _strip_sa(b11.subset((b11.flag & 0x800) == 0))
    if depth_frac < 1.0:
        # fragment-level subsample, qname-keyed (stable crc32 so both
        # mates share one draw and runs are reproducible)
        import zlib

        def frag_keep(b):
            keep = np.zeros(b.n, bool)
            for i in range(b.n):
                keep[i] = (zlib.crc32(b.name_bytes(i)) & 0xFFFF) < \
                    depth_frac * 0x10000
            return keep
        b8 = b8.subset(frag_keep(b8))
        b11 = b11.subset(frag_keep(b11))

    # synthetic fasta: N-padded tiled windows
    fa_path = out_prefix + ".fa"
    with open(fa_path, "w") as f:
        for name, window, span in (("8", W8, SPAN8), ("11", W11, SPAN11)):
            seg = fa.fetch(name, *window).decode()
            f.write(f">{name}\n")
            seq = "N" * 1000 + "".join(
                seg + "N" * (span - len(seg)) for _ in range(tiles)) + \
                "N" * 1000
            for i in range(0, len(seq), 60):
                f.write(seq[i:i + 60] + "\n")
    # .fai
    entries = []
    with open(fa_path) as f:
        byte = 0
        name = None
        ln = 0
        start = 0
        for line in f:
            if line.startswith(">"):
                if name is not None:
                    entries.append((name, ln, start))
                name = line[1:].strip()
                byte += len(line)
                start = byte
                ln = 0
            else:
                ln += len(line.rstrip("\n"))
                byte += len(line)
        entries.append((name, ln, start))
    with open(fa_path + ".fai", "w") as f:
        for name, ln, start in entries:
            f.write(f"{name}\t{ln}\t{start}\t60\t61\n")

    def shift(b, base, span, tile):
        out = copy.copy(b)
        out.pos = (b.pos - base + 1000 + tile * span).astype(b.pos.dtype)
        m8 = b.next_refid == t8
        np_new = np.where(
            m8, b.next_pos - W8[0] + 1000 + tile * SPAN8,
            b.next_pos - W11[0] + 1000 + tile * SPAN11)
        out.next_pos = np_new.astype(b.next_pos.dtype)
        return out

    bam_path = out_prefix + ".bam"
    # declared reference lengths must cover the tiled layout: reusing
    # the source header's hg19 lengths silently clips tiles whose
    # positions land past the declared chromosome end (chr11 at 135 Mb
    # caps out at 5000 tiles of SPAN11) — the scanner plans segments
    # from the header, so clipped tiles are never scanned
    tiled_lengths = []
    for name, old_len in zip(src.header.ref_names,
                             src.header.ref_lengths):
        span = SPAN8 if name == "8" else SPAN11 if name == "11" else None
        tiled_lengths.append(
            old_len if span is None else 2000 + span * tiles)
    import re as _re
    text = src.header.text
    for name, ln in zip(src.header.ref_names, tiled_lengths):
        text = _re.sub(rf"(@SQ\tSN:{_re.escape(name)}\tLN:)\d+",
                       rf"\g<1>{ln}", text)
    w = BamWriter(bam_path, text, src.header.ref_names, tiled_lengths)
    total = 0
    for tile in range(tiles):
        s8 = shift(b8, W8[0], SPAN8, tile)
        for i in range(b8.n):
            w.add_record(s8, i)
        s11 = shift(b11, W11[0], SPAN11, tile)
        for i in range(b11.n):
            w.add_record(s11, i)
        total += b8.n + b11.n
    w.close()
    print(f"generated {bam_path}: {total} reads across {tiles} tiles")
    return bam_path, fa_path, total


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiles", type=int, default=32)
    ap.add_argument("--out", default="/tmp/stress")
    ap.add_argument("--run", action="store_true",
                    help="run the full workflow and report scaling")
    ap.add_argument("-j", "--jobs", type=int, default=1)
    args = ap.parse_args()
    bam, fa, total = generate(args.tiles, args.out)
    if not args.run:
        return
    from manta_tpu.workflow.run import run_workflow
    import gzip
    run_dir = args.out + "_run"
    import shutil
    shutil.rmtree(run_dir, ignore_errors=True)
    t0 = time.time()
    run_workflow([], [bam], fa, run_dir, is_exome=True, n_jobs=args.jobs,
                 verbose=False)
    dt = time.time() - t0
    with gzip.open(f"{run_dir}/results/variants/tumorSV.vcf.gz", "rt") as f:
        records = sum(1 for l in f if not l.startswith("#"))
    expect = 6 * args.tiles
    status = "OK" if records == expect else "MISMATCH"
    print(f"e2e: {dt:.1f}s  {total / dt / 1000:.1f}k reads/s  "
          f"records {records}/{expect} [{status}]")


if __name__ == "__main__":
    main()
