"""A/B the chunk pipeline's overlap depth on the real chip.

Depth 2 overlaps device kernels with host work but the device
runtime's polling thread contends with chunk builds on a single-core
host; depth 1 serializes.  Round 4's winners-only d2h shrank device
wait to a few percent, which may have flipped the winner — this
measures both in ONE process (shared compiles) on syn45 and chrM.

Usage: python tools/depth_ab.py [n_reads] [trials]
"""

import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(batch, reads_fn, trials):
    rps = []
    for t in range(trials):
        reads = reads_fn(t)
        t0 = time.time()
        batch.align_batch(reads)
        rps.append(len(reads) / (time.time() - t0))
    return statistics.median(rps), min(rps), max(rps)


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 49152
    trials = int(sys.argv[2]) if len(sys.argv) > 2 else 5

    from bench import OUT_DIR, _syn45_index, make_reads
    from thermite.testing.synth import write_small_genome
    from thermite.align.batch import BatchAligner
    from thermite.align.driver import AlignOpts
    from thermite.index.build import Index

    opts = AlignOpts(
        min_seed_len=20, min_aln_score_percent=0.0, min_aln_score=30,
        intron_mode=True,
    )
    for label, idx in [
        ("syn45", _syn45_index()),
        (
            "chrM",
            Index.create_from_files(*write_small_genome(OUT_DIR)),
        ),
    ]:
        chrom = idx.seq[idx.refs[0].start_idx : idx.refs[0].end_idx - 1]
        batch = BatchAligner(idx, opts)
        batch.align_batch(make_reads(chrom, n, seed=5))  # compile warmup
        for depth in (2, 1):
            batch.pipeline_depth = depth
            med, lo, hi = run(
                batch, lambda t: make_reads(chrom, n, seed=30 + t), trials
            )
            print(
                f"{label} depth={depth}: median {med:.0f} reads/s "
                f"[{lo:.0f}, {hi:.0f}]",
                flush=True,
            )


if __name__ == "__main__":
    main()
