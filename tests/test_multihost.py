"""Multi-host sharding/merge: per-host output shards merged in host
order must be byte-identical to a single-host run."""

import numpy as np
import pytest

from fixtures import write_fixture

from thermite.align.driver import AlignOpts
from thermite.align.run import align_reads_from_file
from thermite.index.build import Index
from thermite.io.fastx import parse_fastx, revcomp
from thermite.parallel.multihost import merge_shards, shard_bounds


def test_shard_bounds_cover_and_order():
    for n in (0, 1, 7, 100):
        for h in (1, 2, 3, 8):
            spans = [shard_bounds(n, h, i) for i in range(h)]
            assert spans[0][0] == 0 and spans[-1][1] == n
            for (s0, e0), (s1, e1) in zip(spans, spans[1:]):
                assert e0 == s1  # contiguous, order-preserving


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("mh")
    ref, gtf, fq = write_fixture(d)
    idx = Index.create_from_files(ref, gtf)
    return d, idx, fq


@pytest.mark.parametrize("fmt,ext", [("sam", "sam"), ("bam", "bam"), ("paf", "paf")])
def test_merged_shards_equal_single_run(paths, fmt, ext):
    d, idx, fq = paths
    opts = AlignOpts(min_seed_len=3, min_aln_score=0, intron_mode=True)
    reads = list(parse_fastx(fq))
    n_hosts = 3

    # single-host run
    single = d / f"single.{ext}"
    align_reads_from_file(idx, [fq], str(single), fmt, opts, engine="batch")

    # simulated hosts: each aligns its contiguous block and writes a shard
    shard_files = []
    for h in range(n_hosts):
        s, e = shard_bounds(len(reads), n_hosts, h)
        shard_fq = d / f"host{h}.fastq"
        with open(shard_fq, "w") as f:
            for rec in reads[s:e]:
                q = (rec.qual or b"9" * len(rec.seq)).decode()
                f.write(f"@{rec.id.decode()}\n{rec.seq.decode()}\n+\n{q}\n")
        shard = d / f"host{h}.{ext}"
        align_reads_from_file(idx, [str(shard_fq)], str(shard), fmt, opts, engine="batch")
        shard_files.append(str(shard))

    merged = d / f"merged.{ext}"
    merge_shards(shard_files, str(merged), fmt)

    if fmt == "bam":
        # BGZF block boundaries differ; the decompressed streams must match
        import gzip

        assert gzip.open(merged, "rb").read() == gzip.open(single, "rb").read()
    else:
        assert merged.read_bytes() == single.read_bytes()


def test_cli_host_rank_shards_merge_identical(tmp_path):
    """The CLI host-rank surface (--num-hosts/--host-id): two simulated
    hosts align their blocks of one FASTQ, `merge` combines the shards,
    and the result is byte-identical to a single-host run."""
    import os
    import subprocess
    import sys

    from fixtures import write_fixture

    ref, gtf, fq = write_fixture(tmp_path)

    def cli(*args):
        # force the CPU backend in the child (the test's own process
        # is pinned to it by conftest.py)
        env = {**os.environ, "JAX_PLATFORMS": "cpu"}
        subprocess.run(
            [sys.executable, "-m", "thermite.cli", *args],
            check=True, capture_output=True, env=env,
        )

    # reference run in-process (shares the session's jit cache; the
    # subprocess surface under test is the shard flags + merge)
    from thermite.align.driver import AlignOpts
    from thermite.align.run import FORMAT_SAM, align_reads_from_file
    from thermite.index.build import Index

    idx = str(tmp_path / "i.npz")
    cli("index", ref, gtf, "-o", idx)
    single = str(tmp_path / "single.sam")
    opts = AlignOpts(min_seed_len=3, min_aln_score_percent=0.0, min_aln_score=0)
    align_reads_from_file(
        Index.load(idx), [fq], single, FORMAT_SAM, opts, engine="batch"
    )
    out = str(tmp_path / "sharded.sam")
    for h in ("0", "1"):
        cli("align", idx, fq, "-a", "-k3", "-s0", "--min-aln-score=0",
            "-o", out, "--engine", "batch",
            "--num-hosts", "2", "--host-id", h)
    cli("merge", "-o", out, out + ".shard000", out + ".shard001")
    assert open(out).read() == open(single).read()
