"""Production pipeline under a device mesh (BatchAligner mesh mode).

The parallelism story is pure data parallelism over extension problems
(the reference's concurrency contract is clone-across-threads over an
Arc'd index, reference src/wrapper.rs:20-27); these tests run the FULL
batch pipeline — build, sharded kernel, arbitrate, finalize — over the
8-device CPU mesh and require results identical to the single-device
run, plus step-level parity for the sharded stream step.
"""

import numpy as np
import pytest

from thermite.align.batch import BatchAligner
from thermite.align.driver import AlignOpts
from thermite.index.build import Index
from thermite.parallel.mesh import make_mesh
from thermite.testing.synth import make_truth_reads, write_synth_genome


@pytest.fixture(scope="module")
def small_index(tmp_path_factory):
    d = tmp_path_factory.mktemp("meshidx")
    fasta, gtf = write_synth_genome(str(d), 50_000, seed=3, basename="m")
    return Index.create_from_files(fasta, gtf)


def _render(alns):
    return [
        (g.ref_name, g.strand, g.aln_type, g.primary, g.gx_aln.score,
         g.gx_aln.ystart, g.gx_aln.yend, g.gx_aln.xstart, g.gx_aln.xend,
         tuple(g.gx_aln.operations))
        for g in alns
    ]


def test_batch_mesh_identical_to_single(small_index):
    opts = AlignOpts(
        min_seed_len=20, min_aln_score_percent=0.0, min_aln_score=30,
        intron_mode=True,
    )
    reads = [r[1] for r in make_truth_reads(small_index, 300, seed=8)]
    mesh = make_mesh(8)
    meshed = BatchAligner(small_index, opts, mesh=mesh).align_batch(reads)
    single = BatchAligner(small_index, opts).align_batch(reads)
    assert sum(1 for a in meshed if a) > 270
    for a, b in zip(meshed, single):
        assert _render(a) == _render(b)


def test_batch_mesh4_emit_identical_to_single(small_index):
    """The four-card layout (``--mesh 4``) rehearsed on four virtual
    devices: BAM records byte-identical to one device, with the text
    replicated on all four and problem rows split evenly."""
    opts = AlignOpts(
        min_seed_len=20, min_aln_score_percent=0.0, min_aln_score=30,
        intron_mode=True,
    )
    reads = [r[1] for r in make_truth_reads(small_index, 200, seed=9)]
    recs = [(b"r%d" % i, r, b"I" * len(r)) for i, r in enumerate(reads)]
    mesh = make_mesh(4)
    ba = BatchAligner(small_index, opts, mesh=mesh)
    meshed = ba.align_batch_emit(recs, True)
    assert meshed == BatchAligner(small_index, opts).align_batch_emit(recs, True)
    words, _ = ba._ref_text()
    assert words.sharding.is_fully_replicated
    assert len({s.device for s in words.addressable_shards}) == 4
    assert ba._NFWD1 % 4 == 0


def test_sharded_stream_kernel_matches_unsharded(small_index):
    """Step-level: the sharded production stream step (plain-XLA
    kernel on CPU) returns the same header and stream rows as the
    unsharded call."""
    from thermite.ops.layout import (
        meta_row,
        nib_lw,
        pack_reads_nib_host,
        pack_text_nib_host,
    )
    from thermite.ops.stream import get_stream_kernel
    from thermite.parallel.mesh import sharded_stream_kernel

    rng = np.random.default_rng(11)
    text = rng.choice(np.frombuffer(b"ACGT", np.uint8), 4000)
    words = pack_text_nib_host(text)
    lw = np.int32(nib_lw(len(text)))
    RPAD, B = 32, 8
    reads = np.zeros((B, RPAD), np.uint8)
    N = 8 * 8  # eight rows per device
    meta = np.zeros((N, 9), np.int32)
    for i in range(B):
        p = int(rng.integers(100, len(text) - 100))
        reads[i] = text[p : p + RPAD]
        meta[2 * i] = meta_row(p + 4, 1, 40, i * RPAD + 4, 1, RPAD - 4, 8, 8)
        meta[2 * i + 1] = meta_row(p + 3, -1, 12, i * RPAD + 3, -1, 4, 8, 8)
    for r in range(2 * B, N):
        meta[r] = (64, 0, 1, 0, 0, 1, 0, 1, 1)  # empty padding problems

    XMAX, YMAX, W = 32, 64, 32
    mesh = make_mesh(8)
    sharded = sharded_stream_kernel(mesh, XMAX, YMAX, W, 128)
    plain = get_stream_kernel(XMAX, YMAX, W, 128)
    nib = pack_reads_nib_host(reads.reshape(-1))
    a = [np.asarray(v) for v in sharded(words, lw, nib, meta)]
    b = [np.asarray(v) for v in plain(words, lw, nib, meta)]
    assert all((u == v).all() for u, v in zip(a, b))
    assert (a[0][: 2 * B, 0] & 0xFFFF != 0).any()  # some real scores
