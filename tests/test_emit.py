"""C++ record emission == Python writers, byte for byte.

The emitter (csrc thermite_chunk_emit) serializes SAM text / BAM record
blobs straight from the C++ finalize runs; the Python writers are the
parity referees.  Runs the stream route (plain-XLA kernel) on CPU so
the exact production path (single-pass stream + native finalize + C++
emit) is exercised without a GPU.
"""

import numpy as np
import pytest

from fixtures import READS, write_fixture

from thermite.align.batch import BatchAligner, _serialize_records
from thermite.align.driver import AlignOpts
from thermite.index.build import Index


@pytest.fixture(scope="module")
def fixture_index(tmp_path_factory):
    ref, gtf, _ = write_fixture(tmp_path_factory.mktemp("emit"))
    return Index.create_from_files(ref, gtf)


@pytest.fixture(scope="module")
def recs():
    out = [
        (name.encode(), seq.encode(), b"9" * len(seq))
        for name, seq in READS
    ]
    # name with a space (truncation), read with no qual
    out.append((b"spaced name tail", READS[0][1].encode(), b"5" * len(READS[0][1])))
    out.append((b"noqual", READS[4][1].encode(), b""))
    return out


@pytest.mark.parametrize("fmt_bam", [False, True, 2])  # SAM, BAM, PAF
def test_emit_matches_python_writers(fixture_index, recs, fmt_bam):
    opts = AlignOpts(
        min_seed_len=3, min_aln_score_percent=0.0, min_aln_score=0,
        intron_mode=True,
    )
    emitter = BatchAligner(
        fixture_index, opts, backend="stream"
    )
    if not emitter.can_emit():
        pytest.skip("native engine unavailable")
    raw = emitter.align_batch_emit(recs, fmt_bam)

    objs = BatchAligner(
        fixture_index, opts, backend="stream"
    )
    results = objs.align_batch([r[1] for r in recs])
    want = _serialize_records(fixture_index, recs, results, fmt_bam)
    assert raw == want


def test_emit_cli_roundtrip(fixture_index, recs, tmp_path):
    """Emitted BAM records parse back through the from-spec reader with
    the expected fields."""
    from thermite.align.run import FORMAT_BAM, align_reads_from_file
    from thermite.io.bam import read_bam
    from thermite.testing.synth import write_fastq

    fq = str(tmp_path / "r.fastq")
    write_fastq([(n.decode(), s) for n, s, _ in recs[:6]], fq)
    out = str(tmp_path / "o.bam")
    opts = AlignOpts(
        min_seed_len=3, min_aln_score_percent=0.0, min_aln_score=0,
        intron_mode=True,
    )
    align_reads_from_file(
        fixture_index, [fq], out, FORMAT_BAM, opts, engine="batch"
    )
    _, _, it = read_bam(out)
    rows = list(it)
    assert len(rows) >= 6
    assert any(not r.is_unmapped and "NH" in r.tags for r in rows)
