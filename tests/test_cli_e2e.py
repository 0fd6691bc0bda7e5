"""CLI end-to-end: index -> align -> PAF/SAM/BAM, both engines, plus
the BAM round-trip, wrapper API, and the parity-metrics harness
(self-comparison must be all-1.0/identical)."""

import io

import pytest

from fixtures import write_fixture

from thermite.cli import main as cli_main
from thermite.io.bam import read_bam
from thermite.testing.alignment_metrics import compare, to_markdown
from thermite.wrapper import ThermiteAligner


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    ref, gtf, fq = write_fixture(d)
    idx = str(d / "mini.tai.npz")
    assert cli_main(["index", ref, gtf, "-o", idx]) == 0
    return d, idx, fq


FLAGS = ["-k", "3", "--min-aln-score", "0"]


def _align(ws, out_name, extra):
    d, idx, fq = ws
    out = str(d / out_name)
    assert cli_main(["align", idx, fq, "-o", out] + FLAGS + extra) == 0
    return out


def test_sam_outputs_and_engine_parity(ws):
    sam_o = _align(ws, "o.sam", ["-a", "--engine", "oracle"])
    sam_b = _align(ws, "b.sam", ["-a", "--engine", "batch"])
    lines_o = open(sam_o).read()
    lines_b = open(sam_b).read()
    assert lines_o == lines_b, "oracle and batch SAM outputs must be identical"
    assert lines_o.startswith("@SQ\tSN:alpha\tLN:14")
    # every read appears
    body = [l for l in lines_o.splitlines() if not l.startswith("@")]
    names = {l.split("\t")[0] for l in body}
    assert "exact_exonic" in names and "unmapped" in names


def test_paf_output(ws):
    paf = _align(ws, "o.paf", ["--engine", "batch"])
    rows = [l.split("\t") for l in open(paf).read().splitlines() if l]
    assert rows, "paf should contain alignments"
    for r in rows:
        assert len(r) == 13 and r[12] == ""  # trailing tab like the reference
        assert r[4] in "+-"


def test_bam_roundtrip_and_metrics(ws):
    d, idx, fq = ws
    bam = _align(ws, "o.bam", ["-a", "--engine", "batch"])
    header, refs, records = read_bam(bam)
    recs = list(records)
    assert "@SQ\tSN:alpha\tLN:14" in header
    assert "alpha" in refs
    sam = open(_align(ws, "o2.sam", ["-a", "--engine", "batch"])).read()
    sam_body = [l for l in sam.splitlines() if not l.startswith("@")]
    assert len(recs) == len(sam_body)
    # spot-check a mapped record against its SAM line
    by_name = {}
    for r in recs:
        by_name.setdefault(r.qname, r)
    for line in sam_body:
        f = line.split("\t")
        if f[0] in by_name and by_name[f[0]].cigar:
            r = by_name[f[0]]
            assert int(f[1]) == r.flag and int(f[3]) == r.pos + 1
            assert f[5] == r.cigar_string()
            break

    # self-comparison metrics: everything identical (unmapped pairs
    # count as identical too, matching the pysam None==None semantics
    # of the reference harness)
    m = compare(bam, bam)
    assert m.n_identical_align == m.n_reads
    assert m.n_same_chromosome_align == m.n_reads
    assert m.n_same_gene_align == m.n_reads_on_genes
    assert m.n_in1_unaligned == m.n_in2_unaligned
    assert "identical" in to_markdown(m)


def test_wrapper(ws):
    d, idx, fq = ws
    ta = ThermiteAligner(idx)
    assert ta.est_mem(idx) > 0
    assert ta.header().startswith("@SQ")
    # defaults: k=20 -> fixture reads unmapped; switch to fixture opts
    from thermite.align.driver import AlignOpts

    ta.set_opts(AlignOpts(min_seed_len=3, min_aln_score=0))
    recs = ta.align_read(b"exact_exonic", b"ATTACAG", b"9999999")
    assert len(recs) == 1 and recs[0].rname == "alpha"
    assert all(t[0] not in ("TX", "GX", "GN", "RE") for t in recs[0].tags)
    recs = ta.align_read(b"unmapped", b"TGTGTGTGTGTGTGTG", b"9" * 16)
    assert recs[0].flag & 4

    out = ta.align_reads(
        [b"r1", b"r2"], [b"ATTACAG", b"ATTGACTTAAC"], [b"9" * 7, b"9" * 11]
    )
    assert out[0][0].rname == "alpha" and out[1][0].rname == "gamma"


def test_gzipped_fastq_input(ws):
    """Gzip-transparent FASTQ parsing (role of the reference's needletail
    dependency): a .fastq.gz input must produce identical output."""
    import gzip

    d, idx, fq = ws
    gz = str(d / "mini_query.fastq.gz")
    with open(fq, "rb") as src, gzip.open(gz, "wb") as dst:
        dst.write(src.read())
    plain = _align(ws, "plain.sam", ["-a"])
    gzout = str(d / "gz.sam")
    assert cli_main(["align", idx, gz, "-o", gzout, "-a"] + FLAGS) == 0
    assert open(plain).read() == open(gzout).read()


def test_bgzf_blocks_conformant(ws):
    """Walk the BAM's BGZF blocks exactly as htslib does (seek by
    BSIZE+1): the chain must tile the file and end with the EOF marker.
    Guards the BSIZE=length-1 rule that Python's gzip module ignores."""
    import struct

    bam = _align(ws, "conf.bam", ["-a"])
    data = open(bam, "rb").read()
    off = 0
    blocks = 0
    while off < len(data):
        assert data[off : off + 4] == b"\x1f\x8b\x08\x04", f"bad header @{off}"
        xlen = struct.unpack("<H", data[off + 10 : off + 12])[0]
        # find the BC subfield in the extra area
        extra = data[off + 12 : off + 12 + xlen]
        p = 0
        bsize = None
        while p < len(extra):
            si1, si2, slen = extra[p], extra[p + 1], struct.unpack("<H", extra[p + 2 : p + 4])[0]
            if si1 == 66 and si2 == 67:
                bsize = struct.unpack("<H", extra[p + 4 : p + 6])[0]
            p += 4 + slen
        assert bsize is not None
        off += bsize + 1
        blocks += 1
    assert off == len(data), "block chain does not tile the file"
    from thermite.io.bam import _BGZF_EOF

    assert data.endswith(_BGZF_EOF), "missing BGZF EOF marker"
    assert blocks >= 2


def test_index_artifact_path_normalization(ws, tmp_path):
    """save/load agree on the .npz artifact name regardless of the
    extension the caller passes (np.savez always appends .npz)."""
    from thermite.index.build import Index

    d, idx_path, fq = ws
    idx = Index.load(idx_path)
    p = str(tmp_path / "art.tai")
    idx.save(p)
    for name in (p, p + ".npz"):
        loaded = Index.load(name)
        assert loaded.stats() == idx.stats()


def test_gtf_unknown_chromosome_skipped(tmp_path, capfd):
    """Annotations on chromosomes absent from the FASTA are skipped
    with a warning instead of crashing (e.g. full GTF vs reduced FASTA)."""
    from thermite.index.build import Index

    fa = tmp_path / "r.fasta"
    fa.write_text(">chrA\nACGTACGTACGTACGTACGT\n")
    gtf = tmp_path / "r.gtf"
    attrs = 'gene_id "g1"; transcript_id "t1"; gene_name "g1n";'
    attrs2 = 'gene_id "g2"; transcript_id "t2"; gene_name "g2n";'
    gtf.write_text(
        f"chrA\tx\texon\t1\t8\t.\t+\t.\t{attrs}\n"
        f"chrMISSING\tx\texon\t1\t8\t.\t+\t.\t{attrs2}\n"
        'chrA\tx\texon\t1\t8\t.\t+\t.\ttranscript_id "orphan";\n'
    )
    idx = Index.create_from_files(str(fa), str(gtf))
    err = capfd.readouterr().err
    assert "chrMISSING" in err and "skipping" in err
    assert len(idx.txome.txs) == 1


def test_index_accepts_reference_sampling_flags(tmp_path):
    # reference CLI compatibility (src/main.rs:97-102): the sampling
    # flags parse and the produced index aligns identically to one
    # built without them (they are no-ops in this index design)
    ref, gtf, fq = write_fixture(tmp_path)
    idx = str(tmp_path / "flags.tai.npz")
    assert cli_main([
        "index", ref, gtf, "-o", idx,
        "--sa-sampling-rate", "16", "--occ-sampling-rate", "64",
    ]) == 0
    out = str(tmp_path / "flags.sam")
    assert cli_main(["align", idx, fq, "-o", out, "-a"] + FLAGS) == 0
    assert "exact_exonic" in open(out).read()
