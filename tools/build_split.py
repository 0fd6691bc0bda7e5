"""Decompose the host build stage on the bench index: seeding
(thermite_smems) vs full chunk build (seed + window/task/problem
construction + transcript candidates).

Usage: python tools/build_split.py [n_reads] [artifact.npz]
       (default artifact: the cached syn45 bench index; pass
       data/out/genome_scale/wg_index.npz to measure against the
       whole-genome packed table — loads via mmap, reads are
       truth-synthesized from the loaded text)
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8192
    from bench import OUT_DIR, SYN_BP, make_reads
    from thermite.align.batch import BatchAligner
    from thermite.align.driver import AlignOpts
    from thermite.index.build import Index

    art = (
        sys.argv[2]
        if len(sys.argv) > 2
        else os.path.join(OUT_DIR, f"bench_syn{SYN_BP // 1_000_000}.npz")
    )
    t0 = time.time()
    idx = Index.load(art)
    print(f"index loaded {time.time()-t0:.1f} s", file=sys.stderr)
    opts = AlignOpts(
        min_seed_len=20, min_aln_score_percent=0.0, min_aln_score=30,
        intron_mode=True,
    )
    # "stream" here only names the route the aligner WOULD dispatch
    # to; this tool exercises just the host stages (seed, chunk build)
    # and never touches a device — required for >2 GiB texts where the
    # xla test path is guarded off
    be = "stream" if len(sys.argv) > 2 else "xla"
    ba = BatchAligner(idx, opts, backend=be, use_native=True)
    if len(sys.argv) > 2:
        from thermite.testing.synth import make_truth_reads

        reads = [r[1] for r in make_truth_reads(idx, n, seed=77)]
    else:
        chrom = idx.seq[idx.refs[0].start_idx : idx.refs[0].end_idx - 1]
        reads = make_reads(chrom, n, seed=77)

    # A: seeding only
    seeder = ba.seeder
    for r in reads[:256]:
        seeder.all_smems(r)  # warm
    t0 = time.time()
    nm = 0
    for r in reads:
        nm += len(seeder.all_smems(r))
    dt_seed = time.time() - t0

    # B: full native chunk build
    rpad = 96
    reads_pad = np.zeros((len(reads), rpad), np.uint8)
    lens = np.zeros(len(reads), np.int64)
    for i, r in enumerate(reads):
        reads_pad[i, : len(r)] = np.frombuffer(r, np.uint8)
        lens[i] = len(r)
    best = 1e9
    for _ in range(3):
        t0 = time.time()
        pos = 0
        nprob = 0
        while pos < len(reads):
            ch, consumed, meta, tasks = ba.native.build_chunk(
                reads_pad[pos:], lens[pos:], len(reads) - pos,
                ba.PROBLEM_BUDGET,
            )
            nprob += len(meta)
            ba.native.free_chunk(ch)
            pos += consumed
        best = min(best, time.time() - t0)
    print(
        f"seed-only: {1e6*dt_seed/n:.1f} us/read ({n/dt_seed:.0f}/s, {nm} mems)\n"
        f"full build: {1e6*best/n:.1f} us/read ({n/best:.0f}/s, {nprob} problems)"
    )


if __name__ == "__main__":
    main()
