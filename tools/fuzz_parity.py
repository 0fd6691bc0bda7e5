"""Adversarial device-vs-oracle parity fuzz.

Aligns thousands of heavily mutated, mixed-length reads (substitutions,
indels, N bases, both strands, 40-150 bp) through the production batch
pipeline on the REAL device and compares every alignment to the
sequential CPU oracle.  This is the deepest end-to-end check the repo
has.

Usage:
  python tools/fuzz_parity.py [N_READS] [SEED]          # chrM stand-in
  python tools/fuzz_parity.py [N_READS] [SEED] --long   # 40-150 bp mix
"""

import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from thermite.align.batch import BatchAligner  # noqa: E402
from thermite.align.driver import AlignOpts, OracleAligner  # noqa: E402
from thermite.index.build import Index  # noqa: E402
from thermite.io.fastx import revcomp  # noqa: E402


def mutate(rng, r, n_max=8, allow_indels=True):
    r = bytearray(r)
    alpha = b"ACGT"
    for _ in range(int(rng.integers(0, n_max))):
        m = int(rng.integers(0, 4 if allow_indels else 2))
        q = int(rng.integers(1, max(len(r) - 1, 2)))
        if m == 0 and allow_indels and len(r) > 30:
            del r[q]
        elif m == 1 and allow_indels:
            r.insert(q, alpha[int(rng.integers(0, 4))])
        elif m == 2:
            r[q] = alpha[int(rng.integers(0, 4))]
        else:
            r[q] = ord("N")
    return bytes(r)


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    n = int(args[0]) if args else 3000
    seed = int(args[1]) if len(args) > 1 else 777
    long_reads = "--long" in sys.argv
    pct = 0.0
    for a in sys.argv[1:]:
        if a.startswith("--pct="):
            pct = float(a.split("=", 1)[1])

    import tempfile

    from thermite.testing.synth import write_small_genome

    with tempfile.TemporaryDirectory() as d:
        idx = Index.create_from_files(*write_small_genome(d))
    chrM = idx.seq[idx.refs[0].start_idx : idx.refs[0].end_idx - 1]
    rng = np.random.default_rng(seed)
    reads = []
    for _ in range(n):
        L = int(rng.integers(40, 150)) if long_reads else 90
        p = int(rng.integers(0, len(chrM) - L - 1))
        r = mutate(rng, chrM[p : p + L])
        reads.append(revcomp(r) if rng.random() < 0.5 else r)
    reads += [
        b"A" * 60, b"N" * 80, chrM[:45] + revcomp(chrM[:45]), chrM[-60:],
        bytes(b"ACGT"[c] for c in rng.integers(0, 4, 90)),
    ]

    opts = AlignOpts(
        min_seed_len=20, min_aln_score_percent=pct, min_aln_score=30,
        intron_mode=True,
    )
    batch = BatchAligner(idx, opts)
    oracle = OracleAligner(idx, opts)
    got_all = batch.align_batch(reads)
    bad = 0
    for k, (r, got) in enumerate(zip(reads, got_all)):
        want = oracle.align_read(r)
        if got != want:
            bad += 1
            if bad <= 3:
                print(f"MISMATCH read {k}: {r[:50]!r}")
                print("  got ", got[:1])
                print("  want", want[:1])
    print(f"fuzz: {len(reads) - bad}/{len(reads)} identical to oracle")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
