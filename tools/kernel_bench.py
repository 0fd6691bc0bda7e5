"""Stream kernel on the GPU, alone and end to end.

* kernel alone: the production chunk shape (65,536 rows, XMAX 96,
  YMAX 128, band 15), timed with ``block_until_ready``;
* end to end: ``align_batch_emit`` (FASTQ records -> BAM record bytes,
  the CLI's path) of N reads at ``-k20 -s0 --intron-mode`` on the
  45 Mbp synthetic chromosome and on the 16.5 kb chrM stand-in, after a
  warm-up, ``rounds`` timed runs each with the stage report (its
  device-wait lines say whether the pipeline ever waits on the card).

Prints the card's name and power limit and one JSON line of results.

Usage (on the GPU machine): python tools/kernel_bench.py [n_reads] [rounds]
"""

import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OUT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data", "out")


def main():
    n_reads = int(sys.argv[1]) if len(sys.argv) > 1 else 262_144
    rounds = int(sys.argv[2]) if len(sys.argv) > 2 else 2

    import jax

    from thermite.align.batch import BatchAligner
    from thermite.align.driver import AlignOpts
    from thermite.cli import enable_compile_cache
    from thermite.index.build import Index
    from thermite.ops.stream import smax_for, stream_rows, width_for_band
    from thermite.testing.synth import (
        sample_reads,
        stream_problems,
        synth_index_artifact,
        write_small_genome,
    )

    enable_compile_cache()
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("kernel_bench: no GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    print(f"card: {card}", flush=True)
    res = {"card": card}

    ROWS, XMAX, YMAX, BAND = 65_536, 96, 128, 15
    SMAX = smax_for(90 + 90 + BAND + 1)
    dev = [jax.device_put(v) for v in stream_problems(ROWS, XMAX, YMAX, BAND, seed=11)]
    f = jax.jit(
        lambda a, b, c: stream_rows(a, b, c, SMAX, width_for_band(BAND))
    ).lower(*dev).compile()
    ts = []
    for _ in range(20):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*dev))
        ts.append(time.perf_counter() - t0)
    res["kernel_ms"] = statistics.median(ts) * 1e3
    print(f"kernel alone: median {res['kernel_ms']:.3f} ms per {ROWS}-row chunk", flush=True)

    opts = AlignOpts(min_seed_len=20, min_aln_score_percent=0.0, min_aln_score=30,
                     intron_mode=True)
    genomes = {
        "syn45": lambda: Index.load(
            synth_index_artifact(OUT_DIR, 45_000_000, seed=1234, basename="bench_syn45")
        ),
        "chrM_standin": lambda: Index.create_from_files(*write_small_genome(OUT_DIR)),
    }
    for gname, load in genomes.items():
        idx = load()
        ref = idx.refs[0]
        chrom = bytes(idx.seq[ref.start_idx : ref.end_idx - 1])
        recs = [(b"r%d" % i, r.tobytes(), b"I" * 90)
                for i, r in enumerate(sample_reads(chrom, n_reads, 21))]
        ba = BatchAligner(idx, opts)
        t0 = time.perf_counter()
        ba.align_batch_emit(recs[:65_536], True)
        print(f"{gname} warm-up {time.perf_counter() - t0:.2f} s", flush=True)
        rps = []
        for _ in range(rounds):
            ba.stats.reset()
            t0 = time.perf_counter()
            ba.align_batch_emit(recs, True)
            rps.append(n_reads / (time.perf_counter() - t0))
            print(f"{gname}: {rps[-1]:.1f} reads/s\n{ba.stats.report()}", flush=True)
        res[f"{gname}_e2e_reads_per_s"] = statistics.median(rps)
        res[f"{gname}_e2e_reads_per_s_all"] = rps
        del ba, idx
    res["n_reads"] = n_reads
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
