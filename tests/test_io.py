"""I/O layer tests: BGZF, BAM parsing, BAI region queries, FASTA."""

import numpy as np

from manta_tpu.io import BamReader
from manta_tpu.io.bam import C_I, C_M, C_S, C_EQ, C_X, FLAG_UNMAPPED
from manta_tpu.io.bgzf import BgzfWriter, bgzf_compress_block, bgzf_decompress_all
from manta_tpu.io.fasta import FastaReader


def test_bgzf_roundtrip():
    payload = bytes(range(256)) * 100
    block = bgzf_compress_block(payload)
    assert bgzf_decompress_all(block) == payload


def test_bgzf_writer_roundtrip(tmp_path):
    p = tmp_path / "x.gz"
    data = b"hello world\n" * 20000  # spans multiple blocks
    with open(p, "wb") as f:
        w = BgzfWriter(f)
        w.write(data)
        w.close()
    import gzip
    assert gzip.open(p, "rb").read() == data


def test_bam_header(tumor_bam, normal_bam):
    t = BamReader(tumor_bam)
    assert t.header.ref_names[:2] == ["1", "2"] or len(t.header.ref_names) > 0
    assert "8" in t.header.name_to_tid and "11" in t.header.name_to_tid
    n = BamReader(normal_bam)
    assert n.header.sample_names() == ["HCC1954_BL"] or n.header.sample_names()


def test_bam_read_all_consistency(normal_bam):
    r = BamReader(normal_bam)
    batch = r.read_all()
    assert batch.n > 1000
    # refids in range (or -1 for unmapped)
    assert batch.refid.max() < len(r.header.ref_names)
    # CIGAR read-consuming ops must sum to l_seq for mapped reads with seq
    ops = (batch.cigar & 0xF).astype(np.int64)
    lens = (batch.cigar >> 4).astype(np.int64)
    consumes_read = (ops == C_M) | (ops == C_I) | (ops == C_S) | (ops == C_EQ) | (ops == C_X)
    contrib = np.where(consumes_read, lens, 0)
    csum = np.concatenate([[0], np.cumsum(contrib)])
    read_span = csum[batch.cigar_off[1:]] - csum[batch.cigar_off[:-1]]
    seq_len = batch.seq_off[1:] - batch.seq_off[:-1]
    has_cigar = (batch.cigar_off[1:] - batch.cigar_off[:-1]) > 0
    mapped = (batch.flag & FLAG_UNMAPPED) == 0
    check = has_cigar & mapped & (seq_len > 0)
    assert np.array_equal(read_span[check], seq_len[check])
    # sequences decode to ACGTN=
    assert set(np.unique(batch.seq)) <= set(b"=ACMGRSVTWYHKDBN")


def test_bam_fetch_matches_scan(normal_bam):
    r = BamReader(normal_bam)
    assert r.index is not None
    tid = r.header.name_to_tid["8"]
    beg, end = 107652000, 107655000
    via_index = r.fetch("8", beg, end)
    full = r.read_all()
    keep = (full.refid == tid) & (full.pos < end) & (full.end_pos > beg)
    via_scan = full.subset(keep)
    assert via_index.n == via_scan.n
    assert np.array_equal(np.sort(via_index.pos), np.sort(via_scan.pos))


def test_bam_tags(tumor_bam):
    r = BamReader(tumor_bam)
    b = r.fetch("8", 107652000, 107655000)
    # at least some reads should carry standard tags
    found = 0
    for i in range(min(b.n, 200)):
        if b.get_tag(i, b"RG") is not None or b.get_tag(i, b"NM") is not None:
            found += 1
    assert found > 0


def test_fasta(demo_fasta):
    fa = FastaReader(demo_fasta)
    assert "8" in fa.names and "11" in fa.names
    seq = fa.fetch("8", 107653400, 107653420)
    assert len(seq) == 20
    assert set(seq) <= set(b"ACGTN")
    # clamping
    assert fa.fetch("8", -10, 5) == fa.fetch("8", 0, 5)


def test_subset_and_concat(normal_bam):
    from manta_tpu.io.bam import ReadBatch
    r = BamReader(normal_bam)
    b = r.fetch("8", 107652000, 107653000)
    idx = np.arange(0, b.n, 2)
    s = b.subset(idx)
    assert s.n == len(idx)
    assert s.name_str(1) == b.name_str(2)
    assert s.seq_str(1) == b.seq_str(2)
    c = ReadBatch.concat([s, s])
    assert c.n == 2 * s.n
    assert c.name_str(s.n) == s.name_str(0)


def test_parse_records_multi_matches_per_chunk(tumor_bam):
    """mt_bam_{size,fill}_multi must equal per-chunk parse + concat."""
    import numpy as np

    from manta_tpu.io.bam import (
        BamReader, ReadBatch, parse_records, parse_records_multi,
    )
    r = BamReader(tumor_bam)
    tid = r.header.name_to_tid["11"]
    beg, end = 94974000, 94989000
    chunks = r.index.query(tid, beg, end)
    raws = [r._bgzf.read_range(vs, ve) for vs, ve in chunks]
    old = ReadBatch.concat(
        [parse_records(raw, 0, want_overlap=(tid, beg, end))
         for raw in raws])
    new = parse_records_multi(raws, (tid, beg, end))
    assert old.n == new.n and new.n > 0
    for k in ("refid", "pos", "mapq", "flag", "next_refid", "next_pos",
              "tlen", "cigar_off", "cigar", "seq_off", "seq", "qual_off",
              "qual", "name_off", "name", "tag_off"):
        np.testing.assert_array_equal(getattr(old, k), getattr(new, k))
    assert old.tags == new.tags


def test_bai_indexed_bounds(tumor_bam):
    """BAI linear-index bounds: every read start lies within
    [first_indexed_pos, last_indexed_end) even when the header declares
    the full-length chromosome."""
    from manta_tpu.io.bam import BamReader
    r = BamReader(tumor_bam)
    batch = r.read_all()
    for tid in range(len(r.header.ref_names)):
        lo = r.index.first_indexed_pos(tid)
        hi = r.index.last_indexed_end(tid)
        sel = batch.refid == tid
        if not sel.any():
            continue
        assert int(batch.pos[sel].min()) >= lo
        assert int(batch.pos[sel].max()) < hi
        # declared chromosome far exceeds the data span in the demo BAM
        assert hi < r.header.ref_lengths[tid]


def test_read_range_arr_matches_read_range(tumor_bam):
    """Direct-buffer chunk inflation (read_range_arr) is byte-identical
    to the per-block read_range path, cold and with interleaved cache
    hits (reference: htslib bgzf_read over virtual offsets)."""
    from manta_tpu.io.bam import BamReader
    r = BamReader(tumor_bam)
    bg = r.index, r._bgzf
    idx, bg = bg
    batch = r.read_all()
    chunks = []
    for tid in range(len(r.header.ref_names)):
        sel = batch.refid == tid
        if not sel.any():
            continue
        lo = int(batch.pos[sel].min())
        for beg in range(lo, lo + 12000, 3700):
            chunks.extend(idx.query(tid, beg, beg + 2500))
    assert chunks
    # cold: arr first
    arrs = [bg.read_range_arr(vs, ve) for vs, ve in chunks]
    for (vs, ve), a in zip(chunks, arrs):
        assert bytes(bg.read_range(vs, ve)) == a.tobytes()
    # warm/mixed: LRU now holds these blocks
    vs0, ve0 = chunks[0][0], chunks[-1][1]
    assert bytes(bg.read_range(vs0, ve0)) == \
        bg.read_range_arr(vs0, ve0).tobytes()


def test_subset_native_gather_random(normal_bam):
    """mt_gather_ragged subset parity against per-row slicing for a
    random non-contiguous selection."""
    from manta_tpu.io.bam import BamReader
    r = BamReader(normal_bam)
    b = r.read_all()
    rng = np.random.default_rng(7)
    idx = np.sort(rng.choice(b.n, min(b.n, 257), replace=False))
    s = b.subset(idx)
    assert s.n == len(idx)
    for si, bi in enumerate(idx.tolist()):
        assert s.name_bytes(si) == b.name_bytes(bi)
        assert s.tags[s.tag_off[si]:s.tag_off[si + 1]] == \
            b.tags[b.tag_off[bi]:b.tag_off[bi + 1]]
        np.testing.assert_array_equal(
            s.cigar[s.cigar_off[si]:s.cigar_off[si + 1]],
            b.cigar[b.cigar_off[bi]:b.cigar_off[bi + 1]])
        np.testing.assert_array_equal(
            s.seq[s.seq_off[si]:s.seq_off[si + 1]],
            b.seq[b.seq_off[bi]:b.seq_off[bi + 1]])


def test_rg_keep_mask_native(tumor_bam):
    """mt_tag_zmatch RG routing parity against the per-read tag walk."""
    from manta_tpu.io.bam import BamReader
    from manta_tpu.core.fragstats import batch_rg_keep_mask
    r = BamReader(tumor_bam)
    b = r.read_all()
    rgs = r.header.read_group_ids()
    for rg in (list(rgs[:2]) + ["", "no-such-group"]):
        got = batch_rg_keep_mask(b, rg)
        want = np.array([(b.get_tag(i, b"RG") or "") == rg
                         for i in range(b.n)])
        np.testing.assert_array_equal(got, want)


def test_node_mem_override_scales_caches():
    """MANTA_TPU_NODE_GB caps IO-cache sizing as if the node were that
    small (the FFPE-depth memory experiment knob)."""
    import subprocess
    import sys
    out = subprocess.run(
        [sys.executable, "-c",
         "from manta_tpu.io.bgzf import node_mem_gb, _default_cache_blocks;"
         "from manta_tpu.io.bam import BamReader;"
         "print(node_mem_gb(), _default_cache_blocks(),"
         "      BamReader._FETCH_CACHE_BYTES)"],
        env={**__import__('os').environ, "MANTA_TPU_NODE_GB": "8"},
        capture_output=True, text=True, check=True).stdout.split()
    assert float(out[0]) == 8.0
    assert int(out[1]) == 3072          # small-node BGZF LRU (~192 MB)
    assert int(out[2]) == 96 << 20      # small-node fetch budget
