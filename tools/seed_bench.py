"""Host-only seeding microbenchmark (no accelerator needed).

Times ``thermite_smems`` (the chunk build's seed phase) over synthetic
reads against an artifact-loaded index — the access pattern whose
posting-array reads dominate chromosome-scale chunk builds.

Usage: python tools/seed_bench.py [artifact] [n_reads] [passes]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    art = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "data", "out", "bench_syn45.npz",
    )
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 50_000
    passes = int(sys.argv[3]) if len(sys.argv) > 3 else 3

    from bench import make_reads
    from thermite.index.build import Index
    from thermite.seed.native import make_seeder

    t0 = time.time()
    idx = Index.load(art)
    print(f"index loaded in {time.time() - t0:.1f} s", file=sys.stderr)
    t0 = time.time()
    seeder = make_seeder(
        idx.seq_arr, 20, table=getattr(idx, "seed_table", None),
        stride_known=getattr(idx, "seed_stride", None),
    )
    print(f"seeder init in {time.time() - t0:.1f} s", file=sys.stderr)

    chrom = idx.seq[idx.refs[0].start_idx : idx.refs[0].end_idx - 1]
    reads = make_reads(chrom, n, seed=42)
    total_mems = 0
    for p in range(passes):
        t0 = time.time()
        for r in reads:
            total_mems += len(seeder.all_smems(r))
        dt = time.time() - t0
        print(f"pass {p}: {dt / n * 1e6:.2f} us/read ({n / dt:.0f} reads/s)")
    print(f"mems/read {total_mems / n / passes:.2f}")


if __name__ == "__main__":
    main()
