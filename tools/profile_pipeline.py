"""cProfile the on-device batch pipeline's host side.

Builds the chrM (or syn45 with PP_SYN=1) index, warms the kernels with
one batch, then profiles ``align_batch`` (and, with PP_EMIT=1,
``align_batch_emit``) over N reads and prints the top host-side
functions by cumulative time.  The device work overlaps the host
stages, so what shows up here is exactly the single-core host budget
that bounds this deployment's throughput.

Usage: python tools/profile_pipeline.py [n_reads] [sort]
"""

import cProfile
import io
import os
import pstats
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 49152
    sort = sys.argv[2] if len(sys.argv) > 2 else "tottime"

    from bench import OUT_DIR, _syn45_index, make_reads
    from thermite.align.batch import BatchAligner
    from thermite.align.driver import AlignOpts
    from thermite.index.build import Index

    opts = AlignOpts(
        min_seed_len=20, min_aln_score_percent=0.0, min_aln_score=30,
        intron_mode=True,
    )
    if os.environ.get("PP_SYN", "0") == "1":
        idx = _syn45_index()
        chrom = idx.seq[idx.refs[0].start_idx : idx.refs[0].end_idx - 1]
    else:
        from thermite.testing.synth import write_small_genome

        idx = Index.create_from_files(*write_small_genome(OUT_DIR))
        chrom = idx.seq[idx.refs[0].start_idx : idx.refs[0].end_idx - 1]

    batch = BatchAligner(idx, opts)
    reads = make_reads(chrom, n, seed=7)
    import time

    t0 = time.time()
    # warm at FULL batch size: sticky shape buckets mean a smaller
    # warmup leaves the big batch's shapes uncompiled and the profile
    # then attributes multi-second compiles to pipeline stages
    batch.align_batch(make_reads(chrom, n, seed=8))
    print(f"warmup {time.time() - t0:.1f} s", file=sys.stderr)

    batch.stats.reset()
    pr = cProfile.Profile()
    t0 = time.time()
    pr.enable()
    out = batch.align_batch(reads)
    pr.disable()
    dt = time.time() - t0
    print(f"align_batch: {len(reads) / dt:.1f} reads/s ({dt:.2f} s)")
    print(batch.stats.report(), file=sys.stderr)
    s = io.StringIO()
    pstats.Stats(pr, stream=s).sort_stats(sort).print_stats(35)
    print(s.getvalue())

    if os.environ.get("PP_EMIT", "0") == "1":
        recs = [(b"r%d" % i, r, b"I" * len(r)) for i, r in enumerate(reads)]
        batch.align_batch_emit(recs[:4096], True)
        batch.stats.reset()
        pr = cProfile.Profile()
        t0 = time.time()
        pr.enable()
        raw = batch.align_batch_emit(recs, True)
        pr.disable()
        dt = time.time() - t0
        assert len(raw) > len(recs) * 50
        print(f"align_batch_emit: {len(recs) / dt:.1f} reads/s ({dt:.2f} s)")
        print(batch.stats.report(), file=sys.stderr)
        s = io.StringIO()
        pstats.Stats(pr, stream=s).sort_stats(sort).print_stats(25)
        print(s.getvalue())


if __name__ == "__main__":
    main()
