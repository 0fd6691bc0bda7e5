"""End-to-end parity: the batched pipeline (stream route and two-pass
xla test path on CPU) vs the sequential oracle, on the mini fixture and
on reads from the synthetic small gene-dense genome (the chrM stand-in).

This is the key equivalence test for the batching transformation
(fixed band vs the reference's sequential narrowing — see
align/batch.py docstring).
"""

import numpy as np
import pytest

from fixtures import READS, write_fixture

from thermite.align.batch import BatchAligner
from thermite.align.driver import AlignOpts, OracleAligner
from thermite.index.build import Index
from thermite.index.span_lift import lift_tx_span_to_gx
from thermite.index.txome import Exon, Tx, lift_tx_to_gx
from thermite.io.fastx import revcomp


@pytest.fixture(scope="module")
def index(tmp_path_factory):
    ref, gtf, _ = write_fixture(tmp_path_factory.mktemp("fix"))
    return Index.create_from_files(ref, gtf)


def _assert_parity(index, reads, opts, use_native=None, backend="xla"):
    oracle = OracleAligner(index, opts)
    batch = BatchAligner(index, opts, backend=backend, use_native=use_native)
    got_all = batch.align_batch(reads)
    for read, got in zip(reads, got_all):
        want = oracle.align_read(read)
        assert len(got) == len(want), f"read={read!r}: NH {len(got)} != {len(want)}"
        for g, w in zip(got, want):
            assert g == w, f"read={read!r}\n got={g}\nwant={w}"


@pytest.mark.parametrize("intron_mode", [False, True])
@pytest.mark.parametrize("use_native", [False, None])
def test_fixture_parity(index, intron_mode, use_native):
    opts = AlignOpts(min_seed_len=3, min_aln_score=0, intron_mode=intron_mode)
    _assert_parity(
        index, [seq.encode() for _, seq in READS], opts, use_native=use_native
    )


@pytest.mark.parametrize("intron_mode", [False, True])
def test_fixture_parity_pallas_native(index, intron_mode):
    """Full production path on CPU: native C++ build/arbitrate/
    finalize + the plain-XLA stream kernel."""
    opts = AlignOpts(min_seed_len=3, min_aln_score=0, intron_mode=intron_mode)
    _assert_parity(
        index, [seq.encode() for _, seq in READS], opts,
        backend="stream",
    )


@pytest.fixture(scope="module")
def chrm_index(tmp_path_factory):
    from fixtures import small_genome_index

    return small_genome_index(tmp_path_factory.mktemp("synM"))


def test_chrm_parity(chrm_index):
    idx = chrm_index
    rng = np.random.default_rng(7)
    chrM = idx.seq[idx.refs[0].start_idx : idx.refs[0].end_idx - 1]
    reads = []
    for i in range(60):
        p = int(rng.integers(0, len(chrM) - 91))
        r = bytearray(chrM[p : p + 90])
        for _ in range(int(rng.integers(0, 4))):
            r[int(rng.integers(0, 90))] = b"ACGT"[int(rng.integers(0, 4))]
        r = bytes(r)
        if rng.random() < 0.5:
            r = revcomp(r)
        reads.append(r)
    # run configuration of the reference benchmarks (-k20 -s0 --intron-mode)
    opts = AlignOpts(
        min_seed_len=20, min_aln_score_percent=0.0, min_aln_score=30, intron_mode=True
    )
    _assert_parity(idx, reads, opts)


def test_chrm_parity_indels_and_edge_reads(chrm_index):
    """Harder read mix: indels (exercising I/D ops and exon lifting),
    N bases, reads shorter than the seed length, homopolymer junk, and
    reads overlapping the chromosome ends."""
    idx = chrm_index
    rng = np.random.default_rng(21)
    chrM = idx.seq[idx.refs[0].start_idx : idx.refs[0].end_idx - 1]
    alpha = b"ACGT"
    reads = []
    for i in range(50):
        p = int(rng.integers(0, len(chrM) - 100))
        r = bytearray(chrM[p : p + 90])
        for _ in range(int(rng.integers(1, 4))):
            m = int(rng.integers(0, 4))
            q = int(rng.integers(1, len(r) - 1))
            if m == 0:
                del r[q]
            elif m == 1:
                r.insert(q, alpha[int(rng.integers(0, 4))])
            elif m == 2:
                r[q] = alpha[int(rng.integers(0, 4))]
            else:
                r[q] = ord("N")
        r = bytes(r)
        if rng.random() < 0.5:
            r = revcomp(r)
        reads.append(r)
    # edge cases
    reads.append(chrM[:90])                      # chromosome start
    reads.append(chrM[-90:])                     # chromosome end
    reads.append(b"ACGT")                        # shorter than k
    reads.append(b"A" * 90)                      # homopolymer junk
    reads.append(b"N" * 90)                      # all N
    reads.append(revcomp(chrM[: 30]) + chrM[:30] + b"T" * 30)  # chimeric-ish
    opts = AlignOpts(
        min_seed_len=20, min_aln_score_percent=0.0, min_aln_score=30, intron_mode=True
    )
    _assert_parity(idx, reads, opts)
    # and through the full native + stream-kernel production path
    _assert_parity(
        idx, reads[:12] + reads[-6:], opts, backend="stream"
    )


def test_span_lift_matches_full_lift():
    from thermite.align.types import Alignment

    tx = Tx(
        id="", chrom="", strand=True,
        exons=[Exon(3, 6, 0), Exon(10, 13, 0), Exon(20, 27, 0)],
        seq=b"", gene_idx=0,
    )
    rng = np.random.default_rng(0)
    total = 13
    for _ in range(200):
        ys = int(rng.integers(0, total))
        # random op walk from ys
        ops = []
        i = ys
        for _ in range(int(rng.integers(0, 10))):
            op = "MSID"[int(rng.integers(0, 4))]
            if op in "MSD" and i >= total:
                continue
            if op in "MSD":
                i += 1
            ops.append(op)
        aln = Alignment(0, ys, 0, i, 0, 30, 10, ops)
        lifted = lift_tx_to_gx(aln, tx)
        trailing = bool(ops) and ops[-1] not in ("M", "S", "D")
        gys, gye = lift_tx_span_to_gx(ys, i, tx, trailing_nonref=trailing)
        assert (gys, gye) == (lifted.ystart, lifted.yend), f"ys={ys} ops={ops}"


def test_chrm_parity_variable_length_reads(chrm_index):
    """Mixed 40-150 bp reads grow the band (W), column count (YMAX) and
    walk bound (SMAX) buckets; parity must hold across the growth.
    (The narrow band keeps the device kernel's shapes fixed while the
    original-band walks grow the host rows.)"""
    idx = chrm_index
    rng = np.random.default_rng(31)
    chrM = idx.seq[idx.refs[0].start_idx : idx.refs[0].end_idx - 1]
    alpha = b"ACGT"
    reads = []
    for _ in range(80):
        L = int(rng.integers(40, 150))
        p = int(rng.integers(0, len(chrM) - L - 1))
        r = bytearray(chrM[p : p + L])
        for _ in range(int(rng.integers(0, 6))):
            m = int(rng.integers(0, 3))
            q = int(rng.integers(1, max(len(r) - 1, 2)))
            if m == 0 and len(r) > 30:
                del r[q]
            elif m == 1:
                r.insert(q, alpha[int(rng.integers(0, 4))])
            else:
                r[q] = alpha[int(rng.integers(0, 4))]
        r = bytes(r)
        reads.append(revcomp(r) if rng.random() < 0.5 else r)
    opts = AlignOpts(
        min_seed_len=20, min_aln_score_percent=0.0, min_aln_score=30,
        intron_mode=True,
    )
    _assert_parity(idx, reads, opts)


def test_no_annotation_index_parity(tmp_path):
    """Alignment without a transcriptome (the reference's GTF support is
    an optional crate feature): everything classifies intergenic, batch
    must still equal the oracle."""
    ref, _gtf, fq = write_fixture(tmp_path)
    idx = Index.create_from_files(ref, None)
    opts = AlignOpts(min_seed_len=3, min_aln_score=0, intron_mode=True)
    reads = [seq.encode() for _, seq in READS]
    _assert_parity(idx, reads, opts)
    _assert_parity(idx, reads, opts, backend="stream")
