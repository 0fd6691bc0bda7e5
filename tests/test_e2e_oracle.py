"""End-to-end oracle pipeline test on the mini fixture.

Run settings mirror the reference's tiny-fixture smoke run
(`-k3 --min-aln-score=0`, reference data/Makefile:21), in both default
and --intron-mode.
"""

import io

import pytest

from fixtures import write_fixture

from thermite.align.driver import AlignOpts, OracleAligner
from thermite.index.build import Index
from thermite.io.sam import aln_to_sam_record


@pytest.fixture(scope="module")
def index(tmp_path_factory):
    ref, gtf, _ = write_fixture(tmp_path_factory.mktemp("fix"))
    return Index.create_from_files(ref, gtf)


def _align(index, seq, intron_mode=False):
    opts = AlignOpts(min_seed_len=3, min_aln_score=0, intron_mode=intron_mode)
    return OracleAligner(index, opts).align_read(seq)


def _sam(index, name, seq, alns):
    return [
        aln_to_sam_record(index, name.encode(), seq.encode(), b"9" * len(seq), a, len(alns), i + 1)
        for i, a in enumerate(alns)
    ]


def test_index_structure(index):
    # fwd + rc copy per chromosome
    assert [(r.name, r.strand) for r in index.refs[:4]] == [
        ("alpha", True), ("alpha", False), ("beta", True), ("beta", False)
    ]
    assert len(index.txome.genes) == 3
    assert [t.id for t in index.txome.txs] == [
        "alpha_tx", "gamma_tx1", "gamma_tx2", "delta_tx1"
    ]
    assert index.txome.txs[1].seq == b"ATTGACTTAAC"
    assert index.txome.txs[2].seq == b"ATTTTAAC"
    assert index.txome.txs[3].seq == b"GTTAAGTCAAT"


def test_exact_exonic(index):
    alns = _align(index, b"ATTACAG")
    assert len(alns) == 1
    a = alns[0]
    assert (a.ref_name, a.strand, a.aln_type, a.primary) == ("alpha", True, "exonic", True)
    rec = _sam(index, "exact_exonic", "ATTACAG", alns)[0]
    assert (rec.rname, rec.pos, rec.flag, rec.cigar, rec.mapq) == ("alpha", 2, 0, "7M", 255)
    tags = dict((t, v) for t, _, v in rec.tags)
    assert tags["AS"] == "7" and tags["NH"] == "1" and tags["nM"] == "0"
    assert tags["GX"] == "alpha_g" and tags["GN"] == "ALPHA1" and tags["RE"] == "E"
    assert tags["TX"].startswith("alpha_tx,+0,")


def test_revcomp_genome_match_skipped_without_intron_mode(index):
    # beta has no annotations -> best alignment is intergenic -> skipped
    assert _align(index, b"ACTCTCAG") == []
    alns = _align(index, b"ACTCTCAG", intron_mode=True)
    assert len(alns) == 1
    a = alns[0]
    assert (a.ref_name, a.strand, a.aln_type) == ("beta", False, "intergenic")
    rec = _sam(index, "revcomp_genome", "ACTCTCAG", alns)[0]
    # revcomp(ACTCTCAG) = CTGAGAGT at beta[2:10)
    assert (rec.pos, rec.flag, rec.cigar) == (3, 16, "8M")
    assert rec.seq == "CTGAGAGT"  # written on the forward strand


def test_unmapped(index):
    assert _align(index, b"TGTGTGTGTGTGTGTG") == []
    assert _align(index, b"NNNNNNNNNN") == []


def test_spliced_tx1(index):
    alns = _align(index, b"ATTGACTTAAC")
    assert len(alns) == 1
    a = alns[0]
    assert (a.ref_name, a.aln_type, a.strand) == ("gamma", "exonic", True)
    assert index.txome.txs[a.tx_idx].id == "gamma_tx1"
    rec = _sam(index, "spliced_tx1", "ATTGACTTAAC", alns)[0]
    assert (rec.pos, rec.cigar, rec.mapq) == (6, "3M5N3M5N5M", 255)
    tags = dict((t, v) for t, _, v in rec.tags)
    assert tags["AS"] == "11" and tags["TX"] == "gamma_tx1,+0,11M"


def test_spliced_tx2(index):
    alns = _align(index, b"ATTTTAAC")
    assert len(alns) == 1
    assert index.txome.txs[alns[0].tx_idx].id == "gamma_tx2"
    rec = _sam(index, "spliced_tx2", "ATTTTAAC", alns)[0]
    assert (rec.pos, rec.cigar) == (6, "3M13N5M")


def test_spliced_err1(index):
    alns = _align(index, b"ATTGTCTTAAC")
    assert len(alns) == 1
    assert index.txome.txs[alns[0].tx_idx].id == "gamma_tx1"
    rec = _sam(index, "spliced_err1", "ATTGTCTTAAC", alns)[0]
    assert (rec.pos, rec.cigar) == (6, "3M5N3M5N5M")
    tags = dict((t, v) for t, _, v in rec.tags)
    assert tags["AS"] == "9" and tags["nM"] == "1"


def test_spliced_revcomp(index):
    alns = _align(index, b"GTTAAGTCAA")
    assert len(alns) == 1
    a = alns[0]
    assert (a.ref_name, a.strand, a.aln_type) == ("delta", False, "exonic")
    assert index.txome.txs[a.tx_idx].id == "delta_tx1"
    rec = _sam(index, "spliced_revcomp", "GTTAAGTCAA", alns)[0]
    # covers e3(5M) + e2(3M) + last 2 bases of e1 on the forward strand
    assert (rec.pos, rec.flag, rec.cigar) == (7, 16, "2M5N3M5N5M")
    assert rec.seq == "TTGACTTAAC"
    tags = dict((t, v) for t, _, v in rec.tags)
    assert tags["TX"] == "delta_tx1,+0,10M"


def test_multimap_exonic_plus_intronic(index):
    # default mode: only the exonic copy survives
    alns = _align(index, b"ATTACA")
    assert len(alns) == 1
    assert alns[0].aln_type == "exonic"
    rec = _sam(index, "multimap", "ATTACA", alns)[0]
    assert (rec.pos, rec.mapq) == (2, 255)

    # intron mode: exonic at 1 + intronic at 8
    alns = _align(index, b"ATTACA", intron_mode=True)
    assert len(alns) == 2
    assert alns[0].primary and not alns[1].primary
    types = sorted(a.aln_type for a in alns)
    assert types == ["exonic", "intronic"]
    recs = _sam(index, "multimap", "ATTACA", alns)
    assert {r.pos for r in recs} == {2, 9}
    assert all(r.mapq == 3 for r in recs)
    assert [dict((t, v) for t, _, v in r.tags)["HI"] for r in recs] == ["1", "2"]
    assert dict((t, v) for t, _, v in recs[1].tags)["RE"] in "NI"


def test_intron_exon_read(index):
    assert _align(index, b"CGCGCGAC") == []
    alns = _align(index, b"CGCGCGAC", intron_mode=True)
    assert len(alns) >= 1
    prim = alns[0]
    assert prim.gx_aln.score == 8
    # gamma hit is intronic (inside the gene span); delta's gene lives on
    # the '-' copy so the same-sequence hit there is intergenic
    by_ref = {a.ref_name: a.aln_type for a in alns}
    if "gamma" in by_ref:
        assert by_ref["gamma"] == "intronic"
    if "delta" in by_ref:
        assert by_ref["delta"] == "intergenic"


def test_intergenic(index):
    assert _align(index, b"TGGCTAGCTA") == []
    alns = _align(index, b"TGGCTAGCTA", intron_mode=True)
    assert len(alns) == 1
    assert alns[0].aln_type == "intergenic"
    rec = _sam(index, "intergenic", "TGGCTAGCTA", alns)[0]
    assert (rec.rname, rec.pos, rec.cigar) == ("epsilon", 3, "10M")
    tags = dict((t, v) for t, _, v in rec.tags)
    assert tags["RE"] == "I" and "GX" not in tags
