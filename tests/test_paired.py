"""Paired-end pairing layer (align/paired.py) — BEYOND reference
parity (the reference is single-end): FR proper-pair selection, SAM
mate flags/fields, engine-parity through the pairing layer, and the
CLI surface."""

import numpy as np
import pytest

from thermite.align.driver import AlignOpts, OracleAligner
from thermite.align.paired import (
    FLAG_MATE_REVERSE,
    FLAG_MATE_UNMAPPED,
    FLAG_PAIRED,
    FLAG_PROPER,
    FLAG_READ1,
    FLAG_READ2,
    FLAG_REVERSE,
    FLAG_UNMAPPED,
    iter_read_pairs,
    pair_records,
)
from thermite.index.build import Index
from thermite.io.fastx import revcomp
from thermite.testing.synth import write_synth_genome


class Rec:
    def __init__(self, rid, seq, qual=None):
        self.id = rid
        self.seq = seq
        self.qual = qual if qual is not None else b"I" * len(seq)


@pytest.fixture(scope="module")
def index(tmp_path_factory):
    d = tmp_path_factory.mktemp("paired")
    fasta, gtf = write_synth_genome(str(d), 60_000, seed=41, basename="pr")
    return Index.create_from_files(fasta, gtf)


@pytest.fixture(scope="module")
def opts():
    return AlignOpts(
        min_seed_len=20, min_aln_score_percent=0.0, min_aln_score=30,
        intron_mode=True,
    )


def make_pairs(index, n, frag_len=300, read_len=90, seed=7):
    """(rec1, rec2) FR pairs sampled from the forward chromosome."""
    ref = index.refs[0]
    chrom = index.seq[ref.start_idx : ref.end_idx - 1]
    rng = np.random.default_rng(seed)
    pairs = []
    for i in range(n):
        p = int(rng.integers(0, len(chrom) - frag_len))
        frag = chrom[p : p + frag_len]
        r1 = frag[:read_len]
        r2 = revcomp(frag[-read_len:])
        if i % 2:  # alternate which mate is the forward one
            r1, r2 = r2, r1
        pairs.append(
            (Rec(b"pair%d" % i, r1), Rec(b"pair%d" % i, r2), p, frag_len)
        )
    return pairs


def test_proper_pair_flags_and_tlen(index, opts):
    aligner = OracleAligner(index, opts)
    pairs = make_pairs(index, 12)
    n_proper = 0
    for rec1, rec2, p, frag_len in pairs:
        recs = pair_records(
            index, rec1, rec2,
            aligner.align_read(rec1.seq), aligner.align_read(rec2.seq),
            max_insert=1000,
        )
        prim = [r for r in recs if r.flag & FLAG_PROPER]
        if not prim:
            continue  # a pair landing in a repeat may resolve elsewhere
        n_proper += 1
        assert len(prim) == 2
        r1 = next(r for r in prim if r.flag & FLAG_READ1)
        r2 = next(r for r in prim if r.flag & FLAG_READ2)
        for r, other in ((r1, r2), (r2, r1)):
            assert r.flag & FLAG_PAIRED
            assert not (r.flag & (FLAG_UNMAPPED | FLAG_MATE_UNMAPPED))
            # FR: exactly one of the two is reverse
            assert bool(r.flag & FLAG_REVERSE) != bool(
                other.flag & FLAG_REVERSE
            )
            assert bool(r.flag & FLAG_MATE_REVERSE) == bool(
                other.flag & FLAG_REVERSE
            )
            assert r.rnext == "="
            assert r.pnext == other.pos
        assert r1.tlen == -r2.tlen
        assert abs(r1.tlen) == frag_len
        # leftmost mate carries the positive sign
        left = r1 if r1.pos <= r2.pos else r2
        assert left.tlen > 0
    assert n_proper >= 10


def test_unmapped_mate_placement(index, opts):
    aligner = OracleAligner(index, opts)
    rec1, rec2, _, _ = make_pairs(index, 1)[0]
    junk = Rec(rec2.id, b"ACGT" * 22 + b"AC")  # random 90-mer
    rng = np.random.default_rng(3)
    junk.seq = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), 90))
    recs = pair_records(
        index, rec1, junk,
        aligner.align_read(rec1.seq), aligner.align_read(junk.seq),
        max_insert=1000,
    )
    mapped = [r for r in recs if not r.flag & FLAG_UNMAPPED]
    unmapped = [r for r in recs if r.flag & FLAG_UNMAPPED]
    assert mapped and len(unmapped) == 1
    u = unmapped[0]
    prim = next(
        r for r in mapped if r.flag & FLAG_READ1 and not r.flag & 0x100
    )
    assert u.flag & FLAG_PAIRED and u.flag & FLAG_READ2
    # placed at the mapped partner's coordinates
    assert u.rname == prim.rname and u.pos == prim.pos
    assert u.rnext == "=" and u.pnext == prim.pos
    assert u.cigar == "*"
    for r in mapped:
        assert r.flag & FLAG_MATE_UNMAPPED


def test_both_unmapped(index, opts):
    rng = np.random.default_rng(9)
    a = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), 90))
    b = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), 90))
    recs = pair_records(index, Rec(b"x", a), Rec(b"x", b), [], [], 1000)
    assert len(recs) == 2
    for r, mate_flag in zip(recs, (FLAG_READ1, FLAG_READ2)):
        assert r.flag & FLAG_UNMAPPED and r.flag & FLAG_MATE_UNMAPPED
        assert r.flag & FLAG_PAIRED and r.flag & mate_flag
        assert r.rname == "*" and r.pos == 0


def test_batch_engine_parity_through_pairing(index, opts):
    from thermite.align.batch import BatchAligner

    aligner = OracleAligner(index, opts)
    batch = BatchAligner(index, opts)
    pairs = make_pairs(index, 8, seed=13)
    seqs = []
    for rec1, rec2, _, _ in pairs:
        seqs.append(rec1.seq)
        seqs.append(rec2.seq)
    res = batch.align_batch(seqs)
    for k, (rec1, rec2, _, _) in enumerate(pairs):
        want = pair_records(
            index, rec1, rec2,
            aligner.align_read(rec1.seq), aligner.align_read(rec2.seq),
            1000,
        )
        got = pair_records(
            index, rec1, rec2, res[2 * k], res[2 * k + 1], 1000
        )
        assert [r.to_line() for r in got] == [r.to_line() for r in want]


def test_iter_read_pairs_mismatch(tmp_path):
    p1 = tmp_path / "r1.fastq"
    p2 = tmp_path / "r2.fastq"
    p1.write_text("@a\nACGT\n+\nIIII\n@b\nACGT\n+\nIIII\n")
    p2.write_text("@a\nACGT\n+\nIIII\n")
    with pytest.raises(ValueError, match="differ in length"):
        list(iter_read_pairs(str(p1), str(p2)))


def test_cli_paired_e2e(index, opts, tmp_path):
    import subprocess
    import sys

    d = tmp_path
    fasta, gtf = write_synth_genome(str(d), 60_000, seed=41, basename="pr")
    pairs = make_pairs(index, 16, seed=21)

    def write_fq(path, which):
        with open(path, "w") as f:
            for rec1, rec2, _, _ in pairs:
                r = rec1 if which == 0 else rec2
                f.write(
                    f"@{r.id.decode()}\n{r.seq.decode()}\n+\n"
                    f"{'I' * len(r.seq)}\n"
                )

    r1 = d / "r1.fastq"
    r2 = d / "r2.fastq"
    write_fq(r1, 0)
    write_fq(r2, 1)

    from thermite import cli

    art = d / "pr.npz"
    assert cli.main(["index", fasta, gtf, "-o", str(art)]) == 0
    out_o = d / "o.sam"
    out_b = d / "b.sam"
    base = [
        "align", str(art), str(r1), str(r2), "-a", "--paired",
        "-k20", "-s0", "--intron-mode",
    ]
    assert cli.main(base + ["-o", str(out_o), "--engine", "oracle"]) == 0
    assert cli.main(base + ["-o", str(out_b), "--engine", "batch"]) == 0
    assert out_o.read_text() == out_b.read_text()
    lines = [
        ln for ln in out_o.read_text().splitlines() if not ln.startswith("@")
    ]
    assert len(lines) >= 32
    n_proper = sum(1 for ln in lines if int(ln.split("\t")[1]) & FLAG_PROPER)
    assert n_proper >= 2 * 12

    # BAM round trip: mate fields survive the binary encode/decode
    out_bam = d / "p.bam"
    assert cli.main(base + ["-o", str(out_bam), "--engine", "oracle"]) == 0
    from thermite.io.bam import read_bam

    _, ref_names, it = read_bam(str(out_bam))
    sam_rows = [ln.split("\t") for ln in lines]
    brecs = list(it)
    assert len(brecs) == len(sam_rows)
    for br, row in zip(brecs, sam_rows):
        assert br.flag == int(row[1])
        assert br.tlen == int(row[8])
        rnext = row[6]
        if rnext == "*":
            assert br.next_ref_id == -1
        elif rnext == "=":
            assert ref_names[br.next_ref_id] == br.rname
        else:
            assert ref_names[br.next_ref_id] == rnext
        assert br.next_pos == int(row[7]) - 1
    del subprocess, sys


def test_paired_rejects_bad_usage(index, tmp_path):
    from thermite import cli

    with pytest.raises(SystemExit):
        cli.main(["align", "x.npz", "a.fq", "-o", "o.sam", "-a", "--paired"])


def test_paired_shard_merge_identical(index, tmp_path):
    """--paired with --num-hosts: pair-sharded host outputs merge to
    the exact bytes of the unsharded run (both SAM and BAM)."""
    from thermite import cli
    from thermite.parallel.multihost import merge_shards

    d = tmp_path
    fasta, gtf = write_synth_genome(str(d), 60_000, seed=41, basename="pr")
    pairs = make_pairs(index, 10, seed=33)
    for which, path in ((0, d / "r1.fastq"), (1, d / "r2.fastq")):
        with open(path, "w") as f:
            for rec1, rec2, _, _ in pairs:
                r = rec1 if which == 0 else rec2
                f.write(
                    f"@{r.id.decode()}\n{r.seq.decode()}\n+\n"
                    f"{'I' * len(r.seq)}\n"
                )
    art = d / "pr.npz"
    assert cli.main(["index", fasta, gtf, "-o", str(art)]) == 0
    base = [
        "align", str(art), str(d / "r1.fastq"), str(d / "r2.fastq"),
        "-a", "--paired", "-k20", "-s0", "--intron-mode",
        "--engine", "oracle",
    ]
    for ext, fmt in ((".sam", "sam"), (".bam", "bam")):
        single = d / f"single{ext}"
        assert cli.main(base + ["-o", str(single)]) == 0
        shards = []
        for h in range(2):
            out = d / f"sh{ext}"
            assert cli.main(
                base
                + ["-o", str(out), "--num-hosts", "2", "--host-id", str(h)]
            ) == 0
            shards.append(f"{out}.shard{h:03d}")
        merged = d / f"merged{ext}"
        merge_shards(shards, str(merged), fmt)
        if fmt == "sam":
            assert merged.read_bytes() == single.read_bytes()
        else:
            import gzip

            assert gzip.open(merged, "rb").read() == gzip.open(
                single, "rb"
            ).read()


# -- mate rescue ---------------------------------------------------------


def _mutate_every(seq: bytes, step: int, start: int = 10) -> bytes:
    """Flip one base every `step` positions: kills every 20-mer seed
    while leaving clean >=12-base runs for the rescue seeder."""
    out = bytearray(seq)
    for p in range(start, len(out), step):
        out[p] = {65: 67, 67: 71, 71: 84, 84: 65}[out[p]]  # A>C>G>T>A
    return bytes(out)


def test_mate_rescue_recovers_lost_mate(index, opts):
    aligner = OracleAligner(index, opts)
    n_rescued = 0
    for rec1, rec2, p, frag_len in make_pairs(index, 10, seed=21):
        lost = Rec(rec2.id, _mutate_every(rec2.seq, 15))
        alns1 = aligner.align_read(rec1.seq)
        alns2 = aligner.align_read(lost.seq)
        if not alns1 or alns2:
            continue  # only exercise the one-mate-lost shape
        plain = pair_records(index, rec1, lost, alns1, alns2, 1000)
        assert any(
            r.flag & FLAG_UNMAPPED and r.flag & FLAG_READ2 for r in plain
        )
        recs = pair_records(
            index, rec1, lost, alns1, alns2, 1000, rescue_opts=opts
        )
        mapped2 = [
            r for r in recs
            if r.flag & FLAG_READ2 and not r.flag & FLAG_UNMAPPED
        ]
        if not mapped2:
            continue
        n_rescued += 1
        r2 = mapped2[0]
        prim1 = next(
            r for r in recs
            if r.flag & FLAG_READ1 and not r.flag & 0x100
        )
        # rescued mate is a proper FR pair with the anchor
        assert r2.flag & FLAG_PROPER and prim1.flag & FLAG_PROPER
        assert r2.rname == prim1.rname
        assert abs(r2.tlen) == frag_len
        assert (r2.flag & FLAG_REVERSE) != (prim1.flag & FLAG_REVERSE)
        # mate fields cross-link
        assert r2.rnext == "=" and r2.pnext == prim1.pos
        assert prim1.rnext == "=" and prim1.pnext == r2.pos
        for r in recs:
            assert not r.flag & FLAG_MATE_UNMAPPED
    assert n_rescued >= 5  # most fixtures must actually exercise rescue


def test_mate_rescue_rejects_junk(index, opts):
    """A mate unrelated to the window must stay unmapped (no false
    positives from the weaker rescue seed)."""
    aligner = OracleAligner(index, opts)
    rec1, _, _, _ = make_pairs(index, 1, seed=5)[0]
    rng = np.random.default_rng(11)
    junk = Rec(rec1.id, bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), 90)))
    alns1 = aligner.align_read(rec1.seq)
    assert alns1
    recs = pair_records(
        index, rec1, junk, alns1, aligner.align_read(junk.seq), 1000,
        rescue_opts=opts,
    )
    assert any(
        r.flag & FLAG_UNMAPPED and r.flag & FLAG_READ2 for r in recs
    )


def test_mate_rescue_orientation_symmetry(index, opts):
    """Rescue works whichever mate is lost and whichever strand the
    anchor is on (make_pairs alternates orientation)."""
    aligner = OracleAligner(index, opts)
    hit = 0
    for i, (rec1, rec2, p, frag_len) in enumerate(make_pairs(index, 8, seed=77)):
        lost = Rec(rec1.id, _mutate_every(rec1.seq, 15))
        alns2 = aligner.align_read(rec2.seq)
        alns1 = aligner.align_read(lost.seq)
        if not alns2 or alns1:
            continue
        recs = pair_records(
            index, lost, rec2, alns1, alns2, 1000, rescue_opts=opts
        )
        mapped1 = [
            r for r in recs
            if r.flag & FLAG_READ1 and not r.flag & FLAG_UNMAPPED
        ]
        if mapped1:
            hit += 1
            assert mapped1[0].flag & FLAG_PROPER
    assert hit >= 4


def test_cli_no_mate_rescue_flag(index, opts, tmp_path):
    """--no-mate-rescue leaves the lost mate unmapped; default rescues."""
    from thermite import cli

    d = tmp_path
    fasta, gtf = write_synth_genome(str(d), 60_000, seed=41, basename="pr")
    rec1, rec2, _, _ = make_pairs(index, 1, seed=21)[0]
    lost = _mutate_every(rec2.seq, 15)
    (d / "r1.fastq").write_text(
        f"@p\n{rec1.seq.decode()}\n+\n{'I' * len(rec1.seq)}\n"
    )
    (d / "r2.fastq").write_text(
        f"@p\n{lost.decode()}\n+\n{'I' * len(lost)}\n"
    )
    art = d / "pr.npz"
    assert cli.main(["index", fasta, gtf, "-o", str(art)]) == 0
    base = [
        "align", str(art), str(d / "r1.fastq"), str(d / "r2.fastq"),
        "-a", "--paired", "-k20", "-s0", "--intron-mode",
        "--engine", "oracle",
    ]
    out_r = d / "rescued.sam"
    out_n = d / "norescue.sam"
    assert cli.main(base + ["-o", str(out_r)]) == 0
    assert cli.main(base + ["-o", str(out_n), "--no-mate-rescue"]) == 0

    def flags(path):
        return [
            int(line.split("\t")[1])
            for line in path.read_text().splitlines()
            if not line.startswith("@")
        ]
    assert all(not f & FLAG_UNMAPPED for f in flags(out_r))
    assert any(f & FLAG_UNMAPPED for f in flags(out_n))
