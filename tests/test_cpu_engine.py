"""All-native single-core engine (align/cpu.py): byte-identical records
to the batch pipeline's emit path and to the Python writers."""

import pytest

from fixtures import READS, write_fixture

from thermite.align.batch import BatchAligner
from thermite.align.cpu import CppAligner
from thermite.align.driver import AlignOpts
from thermite.index.build import Index


@pytest.fixture(scope="module")
def index(tmp_path_factory):
    ref, gtf, _ = write_fixture(tmp_path_factory.mktemp("cpu"))
    return Index.create_from_files(ref, gtf)


@pytest.fixture(scope="module")
def recs():
    out = [
        (name.encode(), seq.encode(), b"9" * len(seq))
        for name, seq in READS
    ]
    out.append((b"noqual", READS[1][1].encode(), b""))
    return out * 3


@pytest.mark.parametrize("fmt_bam", [False, True])
def test_cpu_engine_matches_batch_emit(index, recs, fmt_bam):
    opts = AlignOpts(
        min_seed_len=3, min_aln_score_percent=0.0, min_aln_score=0,
        intron_mode=True,
    )
    try:
        cpp = CppAligner(index, opts)
    except RuntimeError:
        pytest.skip("native library unavailable")
    got = cpp.align_records(recs, fmt_bam)

    batch = BatchAligner(index, opts, backend="stream")
    want = batch.align_batch_emit(recs, fmt_bam)
    assert got == want


def test_cpu_engine_packed_table_identity(index, recs, monkeypatch):
    """A packed-mode seed table (the genome-scale representation,
    forced tiny via THERMITE_PACKED_MIN) leaves the full engine's
    emitted records byte-identical to the classic table."""
    opts = AlignOpts(
        min_seed_len=3, min_aln_score_percent=0.0, min_aln_score=0,
        intron_mode=True,
    )
    try:
        want = CppAligner(index, opts).align_records(recs, False)
        monkeypatch.setenv("THERMITE_PACKED_MIN", "1")
        got = CppAligner(index, opts).align_records(recs, False)
    except RuntimeError:
        pytest.skip("native library unavailable")
    assert got == want


def test_cpu_engine_narrow_band_identity(index, recs, monkeypatch):
    """The CPU engine's adaptive narrow-band pass (same certificate as
    the device pipeline) leaves the emitted records byte-identical."""
    opts = AlignOpts(
        min_seed_len=3, min_aln_score_percent=0.0, min_aln_score=0,
        intron_mode=True,
    )
    try:
        monkeypatch.setenv("THERMITE_NARROW_BAND", "0")
        full = CppAligner(index, opts)
        monkeypatch.setenv("THERMITE_NARROW_BAND", "4")
        narrow = CppAligner(index, opts)
    except RuntimeError:
        pytest.skip("native library unavailable")
    assert full.narrow_band == 0 and narrow.narrow_band == 4
    assert full.align_records(recs, False) == narrow.align_records(recs, False)


def test_cpu_engine_thread_count_invariance(index, recs):
    """threads>1 parallelizes the scalar-DP loop over problems; every
    problem writes its own row/score slots, so the emitted records are
    bit-identical at any thread count (the production multi-core CPU
    mode vs the 1-thread baseline bench.py measures)."""
    opts = AlignOpts(
        min_seed_len=3, min_aln_score_percent=0.0, min_aln_score=0,
        intron_mode=True,
    )
    try:
        one = CppAligner(index, opts, threads=1)
    except RuntimeError:
        pytest.skip("native library unavailable")
    four = CppAligner(index, opts, threads=4)
    assert four.threads == 4
    want = one.align_records(recs, True)
    assert four.align_records(recs, True) == want
    assert one.stats.cert_patches == four.stats.cert_patches
