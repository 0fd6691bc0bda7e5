"""C++ paired-end emission == Python pair_records + writers, byte for
byte.

``align_paired_emit`` routes the FR pairing decision through
csrc thermite_chunk_pair and serializes records with the C++ emitter;
pairs needing mate rescue are spliced in from the Python writers.  The
referee recomputes every record with align/paired.py pair_records (the
oracle semantics) over the SAME batch-engine alignments and serializes
with the Python writers.  Runs the stream route (plain-XLA kernel)
on CPU so the exact production path is exercised without a GPU.
"""

import numpy as np
import pytest

from thermite.align.batch import BatchAligner
from thermite.align.driver import AlignOpts
from thermite.align.paired import pair_records
from thermite.index.build import Index
from thermite.io.bam import encode_bam_record
from thermite.io.fastx import revcomp
from thermite.io.sam import unique_refs
from thermite.testing.synth import write_synth_genome


class Rec:
    def __init__(self, rid, seq, qual=None):
        self.id = rid
        self.seq = seq
        self.qual = qual if qual is not None else b"I" * len(seq)


@pytest.fixture(scope="module")
def index(tmp_path_factory):
    d = tmp_path_factory.mktemp("paired_emit")
    fasta, gtf = write_synth_genome(str(d), 60_000, seed=43, basename="pe")
    return Index.create_from_files(fasta, gtf)


@pytest.fixture(scope="module")
def opts():
    return AlignOpts(
        min_seed_len=20, min_aln_score_percent=0.0, min_aln_score=30,
        intron_mode=True,
    )


def _mutate_every(seq: bytes, step: int, start: int = 10) -> bytes:
    rot = {65: 67, 67: 71, 71: 84, 84: 65}
    out = bytearray(seq)
    for i in range(start, len(out), step):
        out[i] = rot.get(out[i], 65)
    return bytes(out)


def make_mixed_pairs(index, n=24, frag_len=300, read_len=90, seed=11):
    """FR pairs + adversarial cases: junk mate (unmapped), rescuable
    mate (mutated past seeding but fine for rescue), both-junk pair."""
    ref = index.refs[0]
    chrom = index.seq[ref.start_idx : ref.end_idx - 1]
    rng = np.random.default_rng(seed)
    pairs = []
    for i in range(n):
        p = int(rng.integers(0, len(chrom) - frag_len))
        frag = chrom[p : p + frag_len]
        r1 = frag[:read_len]
        r2 = revcomp(frag[-read_len:])
        if i % 2:
            r1, r2 = r2, r1
        if i % 6 == 3:  # junk mate: unmapped, not rescuable
            r2 = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), read_len))
        elif i % 6 == 5:  # rescuable: seeds killed, rescue k=12 survives
            r2 = _mutate_every(r2, 15)
        pairs.append((Rec(b"p%d" % i, r1), Rec(b"p%d" % i, r2)))
    # one both-unmapped pair
    a = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), read_len))
    b = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), read_len))
    pairs.append((Rec(b"junkpair", a), Rec(b"junkpair", b)))
    return pairs


def _expected_bytes(index, opts, pairs, fmt_bam, rescue):
    """Independent referee: batch-engine alignments (same results the
    emit path sees, by the existing parity tests) -> pair_records ->
    Python writers."""
    batch = BatchAligner(index, opts, backend="stream")
    seqs = []
    for r1, r2 in pairs:
        seqs.append(r1.seq)
        seqs.append(r2.seq)
    res = batch.align_batch(seqs)
    ref_ids = {n: i for i, (n, _) in enumerate(unique_refs(index))}
    out = []
    for k, (r1, r2) in enumerate(pairs):
        for rec in pair_records(
            index, r1, r2, res[2 * k], res[2 * k + 1], 1000,
            rescue_opts=opts if rescue else None,
        ):
            out.append(
                encode_bam_record(rec, ref_ids) if fmt_bam
                else (rec.to_line() + "\n").encode()
            )
    return b"".join(out)


@pytest.mark.parametrize("fmt_bam", [False, True])
@pytest.mark.parametrize("rescue", [True, False])
def test_paired_emit_matches_python(index, opts, fmt_bam, rescue):
    pairs = make_mixed_pairs(index)
    emitter = BatchAligner(index, opts, backend="stream")
    if not emitter.can_emit():
        pytest.skip("native engine unavailable")
    raw = emitter.align_paired_emit(
        [((r1.id, r1.seq, r1.qual), (r2.id, r2.seq, r2.qual))
         for r1, r2 in pairs],
        fmt_bam, max_insert=1000, mate_rescue=rescue,
    )
    # the C++ emitter, not the Python fallback, must have served this
    assert getattr(emitter.stats, "emit_cpp_chunks", 0) >= 1
    assert getattr(emitter.stats, "emit_py_chunks", 0) == 0
    if rescue:
        # the one-mate-unmapped pairs must have gone through the splice
        assert getattr(emitter.stats, "spliced_pairs", 0) >= 2
    want = _expected_bytes(index, opts, pairs, fmt_bam, rescue)
    assert raw == want


def test_paired_emit_chunk_boundary(index, opts):
    """Pair-aligned consumption: force tiny chunks so several chunk
    cuts land inside the batch, and verify pairs never split (output
    equals the referee's, which never chunks)."""
    pairs = make_mixed_pairs(index, n=16, seed=29)
    emitter = BatchAligner(index, opts, backend="stream")
    if not emitter.can_emit():
        pytest.skip("native engine unavailable")
    emitter.PROBLEM_BUDGET = 7  # a few reads per chunk, odd on purpose
    raw = emitter.align_paired_emit(
        [((r1.id, r1.seq, r1.qual), (r2.id, r2.seq, r2.qual))
         for r1, r2 in pairs],
        False, max_insert=1000, mate_rescue=True,
    )
    assert emitter.stats.chunks >= 3
    want = _expected_bytes(index, opts, pairs, False, True)
    assert raw == want


def test_paired_emit_python_build_no_split(index, opts):
    """Without the native engine the pure-Python chunk build must also
    cut only at pair boundaries (object-path pairing would silently
    mispair otherwise)."""
    pairs = make_mixed_pairs(index, n=12, seed=37)
    emitter = BatchAligner(index, opts, backend="xla", use_native=False)
    emitter.PROBLEM_BUDGET = 7  # force several odd-sized budget cuts
    raw = emitter.align_paired_emit(
        [((r1.id, r1.seq, r1.qual), (r2.id, r2.seq, r2.qual))
         for r1, r2 in pairs],
        False, max_insert=1000, mate_rescue=True,
    )
    assert emitter.stats.chunks >= 3
    want = _expected_bytes(index, opts, pairs, False, True)
    assert raw == want


def test_cpp_engine_paired_matches(index, opts):
    """--engine cpp paired output == the batch/Python referee bytes
    (same composition: C++ pairing + emit, oracle-recomputed rescue
    splices)."""
    from thermite.align.cpu import CppAligner

    pairs = make_mixed_pairs(index, n=18, seed=3)
    try:
        cpp = CppAligner(index, opts)
    except RuntimeError:
        pytest.skip("native library unavailable")
    raw = cpp.align_records_paired(
        [((r1.id, r1.seq, r1.qual), (r2.id, r2.seq, r2.qual))
         for r1, r2 in pairs],
        False, max_insert=1000, mate_rescue=True,
    )
    want = _expected_bytes(index, opts, pairs, False, True)
    assert raw == want


def test_wrapper_paired_records(index, opts, tmp_path):
    """align_read_pairs_records == per-pair align_read_pair objects
    serialized with the Python writer (tags stripped both sides)."""
    from thermite.wrapper import ThermiteAligner

    idxp = str(tmp_path / "w.npz")
    index.save(idxp)
    w = ThermiteAligner(idxp)
    w.set_opts(opts)
    pairs = make_mixed_pairs(index, n=8, seed=21)
    raw = w.align_read_pairs_records(
        [r1.id for r1, _ in pairs],
        [r1.seq for r1, _ in pairs],
        [r1.qual for r1, _ in pairs],
        [r2.seq for _, r2 in pairs],
        [r2.qual for _, r2 in pairs],
    )
    want = []
    for r1, r2 in pairs:
        for rec in w.align_read_pair(
            r1.id, r1.seq, r1.qual, r2.seq, r2.qual
        ):
            want.append((rec.to_line() + "\n").encode())
    assert raw == b"".join(want)


def test_cross_chromosome_mates(opts, tmp_path):
    """Mates landing on DIFFERENT chromosomes (orphan pair): RNEXT is
    the partner's NAME, not '=' — exercises the named-mate branch of
    the C++ SAM/BAM emitters, byte-identical to the Python writers."""
    fasta, gtf = write_synth_genome(
        str(tmp_path), 80_000, seed=47, n_chroms=2, basename="xc"
    )
    idx = Index.create_from_files(fasta, gtf)
    fwd = [r for r in idx.refs if r.strand]
    assert len(fwd) == 2
    c1 = idx.seq[fwd[0].start_idx : fwd[0].end_idx - 1]
    c2 = idx.seq[fwd[1].start_idx : fwd[1].end_idx - 1]
    rng = np.random.default_rng(8)
    pairs = []
    for i in range(12):
        p1 = int(rng.integers(0, len(c1) - 90))
        p2 = int(rng.integers(0, len(c2) - 90))
        pairs.append(
            (Rec(b"x%d" % i, c1[p1 : p1 + 90]),
             Rec(b"x%d" % i, revcomp(c2[p2 : p2 + 90])))
        )
    emitter = BatchAligner(idx, opts, backend="stream")
    if not emitter.can_emit():
        pytest.skip("native engine unavailable")
    for fmt_bam in (False, True):
        raw = emitter.align_paired_emit(
            [((r1.id, r1.seq, r1.qual), (r2.id, r2.seq, r2.qual))
             for r1, r2 in pairs],
            fmt_bam, max_insert=1000, mate_rescue=True,
        )
        want = _expected_bytes(idx, opts, pairs, fmt_bam, True)
        assert raw == want
    # the SAM text really carries named RNEXT fields (not '=' / '*')
    raw_sam = emitter.align_paired_emit(
        [((r1.id, r1.seq, r1.qual), (r2.id, r2.seq, r2.qual))
         for r1, r2 in pairs],
        False, max_insert=1000, mate_rescue=True,
    )
    named = [
        l.split("\t")[6]
        for l in raw_sam.decode().splitlines()
        if l.split("\t")[6] not in ("=", "*")
    ]
    assert len(named) >= 12  # cross-chrom mates point at the other name


def test_paired_cli_uses_emit_path(index, opts, tmp_path, monkeypatch):
    """align_paired_from_files routes through align_paired_emit and
    produces the same bytes as the object path (THERMITE_NO_EMIT)."""
    from thermite.align.paired import align_paired_from_files
    from thermite.testing.synth import write_fastq

    # pin the production stream-route configuration through
    # align_paired_from_files
    orig = BatchAligner

    def patched(index_, opts_, **kw):
        kw.setdefault("backend", "stream")
        return orig(index_, opts_, **kw)

    monkeypatch.setattr(
        "thermite.align.batch.BatchAligner", patched
    )

    pairs = make_mixed_pairs(index, n=10, seed=5)
    fq1 = str(tmp_path / "r1.fastq")
    fq2 = str(tmp_path / "r2.fastq")
    write_fastq([(r1.id.decode(), r1.seq) for r1, _ in pairs], fq1)
    write_fastq([(r2.id.decode(), r2.seq) for _, r2 in pairs], fq2)

    out_emit = str(tmp_path / "emit.sam")
    align_paired_from_files(
        index, fq1, fq2, out_emit, "sam", opts, engine="batch",
    )
    out_obj = str(tmp_path / "obj.sam")
    monkeypatch.setenv("THERMITE_NO_EMIT", "1")
    align_paired_from_files(
        index, fq1, fq2, out_obj, "sam", opts, engine="batch",
    )
    assert open(out_emit).read() == open(out_obj).read()

    # the all-native single-core engine writes the same records
    monkeypatch.delenv("THERMITE_NO_EMIT")
    out_cpp = str(tmp_path / "cpp.sam")
    align_paired_from_files(
        index, fq1, fq2, out_cpp, "sam", opts, engine="cpp",
    )
    assert open(out_cpp).read() == open(out_emit).read()
