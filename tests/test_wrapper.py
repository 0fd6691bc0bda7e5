"""Embedding wrapper surface (reference src/wrapper.rs:19-141):
``align_reads_records`` (serialized C++ emit path with TX/GX/GN/RE
stripped) must be byte-identical to serializing the ``align_reads``
object path, and both must agree with the oracle per-read path."""

import pytest

from fixtures import READS, write_fixture

from thermite.align.batch import BatchAligner, _serialize_records
from thermite.index.build import Index
from thermite.wrapper import ThermiteAligner


@pytest.fixture(scope="module")
def index_path(tmp_path_factory):
    d = tmp_path_factory.mktemp("wrap")
    ref, gtf, _ = write_fixture(d)
    idx = Index.create_from_files(ref, gtf)
    path = str(d / "fix.npz")
    idx.save(path)
    return path


@pytest.fixture(scope="module")
def recs():
    out = [
        (name.encode(), seq.encode(), b"9" * len(seq))
        for name, seq in READS
    ]
    out.append((b"noqual", READS[2][1].encode(), b""))
    return out


def _mk(index_path):
    w = ThermiteAligner(index_path)
    # fixture-sized parameters (the reference defaults assume 90 bp
    # reads; the fixture reads are shorter)
    w.align_opts.min_seed_len = 3
    w.align_opts.min_aln_score = 0
    w.align_opts.min_aln_score_percent = 0.0
    w.align_opts.intron_mode = True
    return w


@pytest.mark.parametrize("fmt_bam", [False, True])
def test_wrapper_records_match_object_path(index_path, recs, fmt_bam):
    w = _mk(index_path)
    # production emit surface (C++): the full device pipeline shape
    # on CPU via the plain-XLA stream kernel
    from thermite.align.batch import BatchAligner as BA

    w._batch = BA(w.index, w.align_opts, backend="stream")
    names = [r[0] for r in recs]
    reads = [r[1] for r in recs]
    quals = [r[2] for r in recs]
    got = w.align_reads_records(names, reads, quals, fmt_bam=fmt_bam)

    # referee: object path + Python writers, tags stripped
    w2 = _mk(index_path)
    results = []
    for recs_list in w2.align_reads(names, reads, quals):
        results.append(recs_list)
    # serialize the object-path records directly
    from thermite.io.bam import encode_bam_record
    from thermite.io.sam import unique_refs

    ref_ids = {n: i for i, (n, _) in enumerate(unique_refs(w2.index))}
    want = b"".join(
        encode_bam_record(r, ref_ids) if fmt_bam
        else (r.to_line() + "\n").encode()
        for group in results
        for r in group
    )
    assert got == want


def test_wrapper_records_strip_tags(index_path, recs):
    w = _mk(index_path)
    from thermite.align.batch import BatchAligner as BA

    w._batch = BA(w.index, w.align_opts, backend="stream")
    sam = w.align_reads_records(
        [r[0] for r in recs], [r[1] for r in recs], [r[2] for r in recs]
    )
    for tag in (b"TX:Z:", b"GX:Z:", b"GN:Z:", b"RE:A:"):
        assert tag not in sam
    # one+ record per read, AS/NH kept on mapped lines
    assert sam.count(b"\n") >= len(recs)
    assert b"AS:i:" in sam


def test_wrapper_align_read_pair(index_path):
    """Paired embedding surface: pair flags present, tags stripped,
    and per-mate alignments identical to the single-end path."""
    from thermite.align.paired import (
        FLAG_PAIRED,
        FLAG_PROPER,
        FLAG_READ1,
        FLAG_READ2,
    )
    from thermite.io.fastx import revcomp

    w = _mk(index_path)
    ref = w.index.refs[0]
    chrom = w.index.seq[ref.start_idx : ref.end_idx - 1]
    frag = chrom[4 : 4 + 60]
    r1, r2 = frag[:30], revcomp(frag[-30:])
    recs = w.align_read_pair(b"p0", r1, b"I" * 30, r2, b"I" * 30)
    assert len(recs) >= 2
    assert any(r.flag & FLAG_READ1 for r in recs)
    assert any(r.flag & FLAG_READ2 for r in recs)
    for r in recs:
        assert r.flag & FLAG_PAIRED
        assert all(t[0] not in ("TX", "GX", "GN", "RE") for t in r.tags)
    prim = [r for r in recs if r.flag & FLAG_PROPER]
    assert len(prim) == 2 and prim[0].tlen == -prim[1].tlen != 0
