"""Synthesize benchmark reads from an indexed chromosome.

The reference benchmarks against pbmc10k 500k-read FASTQs that are
git-LFS-elided upstream (reference .MISSING_LARGE_BLOBS), so the E2E
driver synthesizes deterministic reads from the same chromosome:
90 bp windows, 0-3 substitutions, both strands — the same generator
bench.py uses.

Usage: python make_reads.py REF.fasta N OUT.fastq [SEED]
"""

import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from thermite.io.fastx import parse_fastx, revcomp  # noqa: E402


def main():
    ref_path, n, out_path = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    seed = int(sys.argv[4]) if len(sys.argv) > 4 else 7
    rec = next(iter(parse_fastx(ref_path)))
    chrom = rec.seq.upper()
    cname = rec.id.split(b" ")[0].decode()
    rng = np.random.default_rng(seed)
    with open(out_path, "w") as f:
        for i in range(n):
            p = int(rng.integers(0, len(chrom) - 91))
            r = bytearray(chrom[p : p + 90])
            for _ in range(int(rng.integers(0, 4))):
                r[int(rng.integers(0, 90))] = ord(
                    "ACGT"[int(rng.integers(0, 4))]
                )
            r = bytes(r)
            strand = "+"
            if rng.random() < 0.5:
                r = revcomp(r)
                strand = "-"
            # the name encodes the TRUE origin (0-based half-open) so
            # the metrics harness --truth mode has a non-circular
            # referee (role of the reference's Cell Ranger BAM)
            name = f"synth{i}:{cname}:{p}:{p + 90}:{strand}"
            f.write(f"@{name}\n{r.decode()}\n+\n{'I' * 90}\n")


if __name__ == "__main__":
    main()
