"""Ground-truth accuracy referee (alignment_metrics --truth).

The synthetic read generators encode each read's true origin in its
name; the --truth mode scores a BAM against that encoding with no
comparison aligner in the loop — the non-circular accuracy contract
standing in for the reference's Cell Ranger BAM
(reference lib/testing/comparison_metrics.txt).
"""

import subprocess
import sys

import numpy as np
import pytest

from thermite.align.driver import AlignOpts
from thermite.align.run import FORMAT_BAM, align_reads_from_file
from thermite.index.build import Index
from thermite.testing.alignment_metrics import (
    truth_compare,
    truth_to_markdown,
)
from thermite.testing.synth import (
    make_truth_reads,
    write_fastq,
    write_synth_genome,
)


@pytest.fixture(scope="module")
def truth_bam(tmp_path_factory):
    d = tmp_path_factory.mktemp("truth")
    fasta, gtf = write_synth_genome(str(d), 40_000, seed=5, basename="tg")
    idx = Index.create_from_files(fasta, gtf)
    reads = make_truth_reads(idx, 80, seed=9, max_subst=2)
    fq = str(d / "reads.fastq")
    write_fastq(reads, fq)
    bam = str(d / "out.bam")
    opts = AlignOpts(
        min_seed_len=20, min_aln_score_percent=0.0, min_aln_score=30,
        intron_mode=True,
    )
    align_reads_from_file(idx, [fq], bam, FORMAT_BAM, opts, engine="batch")
    return bam


def test_truth_metrics_high_accuracy(truth_bam):
    m = truth_compare(truth_bam)
    assert m.n_reads == 80
    # error-bearing synthetic reads on their own genome: everything
    # must map back to (at least overlap) its true locus
    assert m.n_aligned == 80
    assert m.n_true_chrom == 80
    assert m.n_true_overlap == 80
    assert m.n_primary_true_overlap == 80
    # substitutions near read ends legitimately clip, shrinking the
    # span — exact-span identity is high but not 1.0 by construction
    assert m.n_true_identical >= 60
    table = truth_to_markdown(m)
    assert "|aligned reads | 1.0|" in table


def test_truth_cli(truth_bam):
    out = subprocess.run(
        [sys.executable, "-m", "thermite.testing.alignment_metrics",
         "--truth", truth_bam],
        capture_output=True, text=True, check=True,
    ).stdout
    assert "|aligned reads | 1.0|" in out


def test_truth_rejects_unencoded_names():
    with pytest.raises(SystemExit):
        from thermite.testing.alignment_metrics import _parse_truth

        _parse_truth("synth0")
