"""Mid-scale synthetic genome parity: multi-chromosome, hundreds of
spliced genes on both strands, junction-spanning reads.

Stands in for the reference's chr21 regression (the chr21 blobs are
git-LFS-elided upstream): validates coordinate mapping across many
chromosomes, larger seed/interval tables, and exon lifting at scale —
batch pipeline output must equal the oracle read-for-read.
"""

import numpy as np
import pytest

from thermite.align.batch import BatchAligner
from thermite.align.driver import AlignOpts, OracleAligner
from thermite.index.build import Index
from thermite.io.fastx import revcomp


@pytest.fixture(scope="module")
def midscale(tmp_path_factory):
    d = tmp_path_factory.mktemp("mid")
    rng = np.random.default_rng(99)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    chroms = {}
    gtf_lines = []
    gene_i = 0
    for ci, (name, length) in enumerate(
        [("syn1", 120_000), ("syn2", 80_000), ("syn3", 50_000)]
    ):
        seq = alpha[rng.integers(0, 4, length)].tobytes()
        chroms[name] = seq
        # ~1 gene / 2kb, 3 exons of 150bp separated by 300bp introns
        pos = 500
        while pos + 1500 < length:
            strand = "+" if rng.random() < 0.5 else "-"
            gid = f"G{gene_i:04d}"
            tid = f"T{gene_i:04d}"
            exons = [(pos, pos + 150), (pos + 450, pos + 600), (pos + 900, pos + 1050)]
            attrs = (
                f'gene_id "{gid}"; transcript_id "{tid}"; gene_name "{gid}n";'
            )
            for s, e in exons:  # GTF is 1-based inclusive
                gtf_lines.append(
                    f"{name}\tsyn\texon\t{s + 1}\t{e}\t.\t{strand}\t.\t{attrs}"
                )
            gene_i += 1
            pos += int(rng.integers(1800, 2600))
    fasta = d / "mid.fasta"
    with open(fasta, "w") as f:
        for name, seq in chroms.items():
            f.write(f">{name}\n{seq.decode()}\n")
    gtf = d / "mid.gtf"
    gtf.write_text("\n".join(gtf_lines) + "\n")
    return Index.create_from_files(str(fasta), str(gtf)), chroms


def _mutate(rng, r):
    r = bytearray(r)
    for _ in range(int(rng.integers(0, 3))):
        r[int(rng.integers(0, len(r)))] = b"ACGT"[int(rng.integers(0, 4))]
    return bytes(r)


def test_midscale_parity(midscale):
    index, chroms = midscale
    rng = np.random.default_rng(7)
    names = list(chroms)
    reads = []
    # genomic reads from every chromosome, both strands
    for _ in range(60):
        name = names[int(rng.integers(0, len(names)))]
        seq = chroms[name]
        p = int(rng.integers(0, len(seq) - 91))
        r = _mutate(rng, seq[p : p + 90])
        reads.append(revcomp(r) if rng.random() < 0.5 else r)
    # junction-spanning reads from spliced transcripts
    txs = index.txome.txs
    for _ in range(40):
        tx = txs[int(rng.integers(0, len(txs)))]
        if len(tx.seq) < 91:
            continue
        p = int(rng.integers(0, len(tx.seq) - 90))
        r = _mutate(rng, tx.seq[p : p + 90])
        reads.append(revcomp(r) if rng.random() < 0.5 else r)

    opts = AlignOpts(
        min_seed_len=20, min_aln_score_percent=0.0, min_aln_score=30,
        intron_mode=True,
    )
    oracle = OracleAligner(index, opts)
    batch = BatchAligner(index, opts, backend="xla")
    got_all = batch.align_batch(reads)
    n_spliced = 0
    for read, got in zip(reads, got_all):
        want = oracle.align_read(read)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g == w, f"read={read!r}\n got={g}\nwant={w}"
        if got and any(op == ("N", 300) for op in got[0].gx_aln.operations):
            n_spliced += 1
    assert n_spliced >= 8, "junction reads should produce intron (N) ops"
