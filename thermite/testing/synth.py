"""Deterministic synthetic genomes + reads for benches and scale tests.

The reference benchmarks against GRCh38 chr21 + pbmc10k reads, all
git-LFS-elided upstream (reference .MISSING_LARGE_BLOBS); these
generators synthesize stand-ins at matched scale: a chromosome of the
requested length with spliced genes on both strands (chr21-like
density), and error-bearing reads whose TRUE origin is encoded in the
read name so accuracy can be scored against ground truth
(``thermite.testing.alignment_metrics`` --truth mode).
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

_ALPHA = np.frombuffer(b"ACGT", np.uint8)


def synth_chromosome(
    length: int,
    rng: np.random.Generator,
    name: str = "syn1",
    gene_every: int = 22_000,
) -> Tuple[bytes, List[str]]:
    """One random chromosome + GTF lines (~chr21 gene density at the
    default spacing: chr21 is 46.7 Mbp with ~2k genes incl. ncRNA).

    Genes are 3-exon transcripts (150 bp exons, 300 bp introns) on
    random strands; every gene gets one transcript.
    """
    seq = _ALPHA[rng.integers(0, 4, length)].tobytes()
    gtf: List[str] = []
    pos = 500
    gi = 0
    while pos + 1500 < length:
        strand = "+" if rng.random() < 0.5 else "-"
        gid = f"{name}G{gi:05d}"
        attrs = (
            f'gene_id "{gid}"; transcript_id "{gid}T"; '
            f'gene_name "{gid}n";'
        )
        for s, e in ((pos, pos + 150), (pos + 450, pos + 600), (pos + 900, pos + 1050)):
            gtf.append(
                f"{name}\tsyn\texon\t{s + 1}\t{e}\t.\t{strand}\t.\t{attrs}"
            )
        gi += 1
        pos += int(rng.integers(gene_every * 3 // 4, gene_every * 5 // 4))
    return seq, gtf


def write_synth_genome(
    out_dir: str,
    total_bp: int,
    seed: int = 1234,
    n_chroms: int = 1,
    basename: str = "syn",
) -> Tuple[str, str]:
    """Write a synthetic FASTA+GTF of ``total_bp`` across ``n_chroms``
    chromosomes; returns (fasta_path, gtf_path)."""
    os.makedirs(out_dir, exist_ok=True)
    fasta = os.path.join(out_dir, f"{basename}.fasta")
    gtf_path = os.path.join(out_dir, f"{basename}.gtf")
    rng = np.random.default_rng(seed)
    per = total_bp // n_chroms
    with open(fasta, "w") as ff, open(gtf_path, "w") as gf:
        for c in range(n_chroms):
            name = f"{basename}{c + 1}"
            seq, gtf = synth_chromosome(per, rng, name=name)
            ff.write(f">{name}\n")
            # 80-col wrapping is unnecessary for our parser but cheap
            ff.write(seq.decode())
            ff.write("\n")
            gf.write("\n".join(gtf))
            gf.write("\n")
    return fasta, gtf_path


SMALL_GENOME_BP = 16_569  # GRCh38 chrM


def synth_small_chromosome(
    length: int, rng: np.random.Generator, name: str = "synM"
) -> Tuple[bytes, List[str]]:
    """A chrM-like chromosome: small, gene-dense (genes cover most of
    it), single-exon genes on both strands (mostly '+', like chrM's
    heavy strand), neighbours that overlap (as ATP8/ATP6 and ND4L/ND4
    do), and a few polycistronic transcripts spanning two genes."""
    seq = _ALPHA[rng.integers(0, 4, length)].tobytes()
    gtf: List[str] = []
    pos = int(rng.integers(0, 600))
    gi = 0
    prev = None
    while True:
        glen = int(rng.choice([70, 70, 70, 300, 700, 1000, 1500]))
        glen += int(rng.integers(-10, 60))
        end = min(pos + glen, length)
        if end - pos < 60:
            break
        strand = "+" if rng.random() < 0.75 else "-"
        gid = f"{name}G{gi:03d}"

        def exon(tid, s, e, st=strand, g=gid):
            gtf.append(
                f"{name}\tsyn\texon\t{s + 1}\t{e}\t.\t{st}\t.\t"
                f'gene_id "{g}"; transcript_id "{tid}"; gene_name "{g}n";'
            )

        exon(f"{gid}T", pos, end)
        if prev is not None and prev[2] == strand and rng.random() < 0.2:
            # polycistronic precursor spanning the previous gene too
            exon(f"{gid}P", prev[0], end)
        prev = (pos, end, strand)
        gi += 1
        # mostly abutting or overlapping neighbours, small gaps
        r = rng.random()
        pos = end - int(rng.integers(1, 50)) if r < 0.25 else end + int(rng.integers(0, 30))
    return seq, gtf


def write_small_genome(
    out_dir: str, seed: int = 16, basename: str = "synM"
) -> Tuple[str, str]:
    """Write the seeded chrM stand-in (``SMALL_GENOME_BP``, one
    chromosome); returns (fasta_path, gtf_path)."""
    os.makedirs(out_dir, exist_ok=True)
    fasta = os.path.join(out_dir, f"{basename}.fasta")
    gtf_path = os.path.join(out_dir, f"{basename}.gtf")
    seq, gtf = synth_small_chromosome(
        SMALL_GENOME_BP, np.random.default_rng(seed), name=basename
    )
    with open(fasta, "w") as ff:
        ff.write(f">{basename}\n{seq.decode()}\n")
    with open(gtf_path, "w") as gf:
        gf.write("\n".join(gtf) + "\n")
    return fasta, gtf_path


def make_truth_reads(
    index,
    n: int,
    read_len: int = 90,
    seed: int = 3,
    max_subst: int = 3,
) -> List[Tuple[str, bytes]]:
    """(name, seq) reads drawn from the forward chromosome copies of an
    Index, substitution errors, both strands.  The name encodes the
    ground truth as ``synth{i}:{chrom}:{start}:{end}:{strand}`` with a
    0-based half-open genome interval and +/- strand — the accuracy
    referee (alignment_metrics --truth) parses this.
    """
    from ..io.fastx import revcomp

    rng = np.random.default_rng(seed)
    fwd = [r for r in index.refs if r.strand and r.len > read_len + 1]
    lens = np.array([r.len for r in fwd], np.float64)
    pchrom = lens / lens.sum()
    out: List[Tuple[str, bytes]] = []
    for i in range(n):
        ref = fwd[int(rng.choice(len(fwd), p=pchrom))]
        p = int(rng.integers(0, ref.len - read_len - 1))
        seq = bytearray(
            index.seq[ref.start_idx + p : ref.start_idx + p + read_len]
        )
        for _ in range(int(rng.integers(0, max_subst + 1))):
            seq[int(rng.integers(0, read_len))] = _ALPHA[
                int(rng.integers(0, 4))
            ]
        seq = bytes(seq)
        strand = "+"
        if rng.random() < 0.5:
            seq = revcomp(seq)
            strand = "-"
        out.append(
            (f"synth{i}:{ref.name}:{p}:{p + read_len}:{strand}", seq)
        )
    return out


def synth_index_artifact(
    out_dir: str, total_bp: int, seed: int = 1234, basename: str = "syn"
) -> str:
    """Path of a cached index artifact (seed table included) for the
    synthetic genome ``write_synth_genome(out_dir, total_bp, seed)``;
    built through the ``thermite index`` command when missing."""
    art = os.path.join(out_dir, f"{basename}.npz")
    if not os.path.exists(art):
        from ..cli import main as cli_main

        fasta, gtf = write_synth_genome(out_dir, total_bp, seed, basename=basename)
        cli_main(["index", fasta, gtf, "-o", art])
    return art


def sample_reads(
    chrom: bytes, n: int, seed: int, read_len: int = 90, max_subst: int = 3
) -> np.ndarray:
    """(n, read_len) uint8 reads from uniform positions of ``chrom`` with
    0..max_subst random substitutions, half reverse-complemented —
    vectorized, for workloads of hundreds of thousands of reads."""
    rng = np.random.default_rng(seed)
    src = np.frombuffer(chrom, np.uint8)
    pos = rng.integers(0, len(src) - read_len, n)
    reads = src[pos[:, None] + np.arange(read_len)]
    nsub = rng.integers(0, max_subst + 1, n)
    for k in range(max_subst):
        rows = np.flatnonzero(nsub > k)
        cols = rng.integers(0, read_len, len(rows))
        reads[rows, cols] = _ALPHA[rng.integers(0, 4, len(rows))]
    comp = np.arange(256, dtype=np.uint8)
    comp[list(b"ACGTN")] = list(b"TGCAN")
    rc = rng.random(n) < 0.5
    reads[rc] = comp[reads[rc, ::-1]]
    return reads


def write_fastq_array(path: str, reads: np.ndarray, prefix: str = "r") -> None:
    """FASTQ of (n, L) uint8 reads named ``{prefix}{i}`` with 'I' quals."""
    qual = "I" * reads.shape[1]
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@{prefix}{i}\n{r.tobytes().decode()}\n+\n{qual}\n")


def stream_problems(n: int, XMAX: int, YMAX: int, band_max: int, seed: int):
    """Stream-kernel inputs (x, y, params) shaped like a production chunk
    of 90 bp reads: flanks of 1..90 bases at band <= band_max with the
    original x-drop of 60, mostly near-copies (long alignments that
    certify), a fifth with an indel wider than the band (certificate
    failures) and a few unrelated.  Codes 1..4, zero beyond each length."""
    rng = np.random.default_rng(seed)
    xlen = rng.integers(1, min(91, XMAX + 1), n)
    band = np.where(rng.random(n) < 0.9, band_max, rng.integers(1, band_max + 1, n))
    xd = np.where(rng.random(n) < 0.8, 60, rng.integers(1, 61, n))
    ylen = np.minimum(xlen + band + 1, YMAX)
    x = rng.integers(1, 5, (n, XMAX)).astype(np.uint8)
    col = np.arange(YMAX)[None, :]
    cut = rng.integers(0, 90, n)[:, None]
    gap = rng.integers(1, 40, n)[:, None]
    kind = rng.random(n)[:, None]
    src = np.where(
        kind < 0.1, np.where(col < cut, col, col - gap),  # insertion in y
        np.where(kind < 0.2, np.where(col < cut, col, col + gap), col),  # deletion
    )
    y = np.take_along_axis(x, np.clip(src, 0, XMAX - 1), axis=1)
    noise = rng.integers(1, 5, (n, YMAX)).astype(np.uint8)
    y = np.where((src < 0) | (src >= xlen[:, None]) | (kind > 0.95), noise, y)
    for _ in range(3):
        y[np.arange(n), rng.integers(0, YMAX, n)] = rng.integers(1, 5, n)
    x[np.arange(XMAX)[None, :] >= xlen[:, None]] = 0
    y[col >= ylen[:, None]] = 0
    params = np.stack([xlen, ylen, band, xd], axis=1).astype(np.int32)
    return x, y, params


def write_fastq(reads: List[Tuple[str, bytes]], path: str) -> None:
    with open(path, "w") as f:
        for name, seq in reads:
            f.write(f"@{name}\n{seq.decode()}\n+\n{'I' * len(seq)}\n")
