"""Per-thread CPU accounting for the on-device pipeline.

The bench stage timers attribute wall time to pipeline stages, but the
JAX runtime threads compete with the host build for cores, and the
"build" stage absorbs that contention.  This tool measures the tax
directly: it
snapshots /proc/self/task/*/stat utime+stime around a warmed
align_batch_emit run and prints each thread's CPU seconds, so the
"device-poll contention" hypothesis rests on thread-level evidence
instead of stage-timer inference.

Usage (GPU machine):  python tools/thread_tax.py [n_reads]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def thread_cpu():
    """tid -> (comm, cpu_seconds) from /proc/self/task/*/stat."""
    hz = os.sysconf("SC_CLK_TCK")
    out = {}
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                raw = f.read()
        except OSError:
            continue
        # comm may contain spaces; it is parenthesized
        lp, rp = raw.index("("), raw.rindex(")")
        comm = raw[lp + 1 : rp]
        fields = raw[rp + 2 :].split()
        utime, stime = int(fields[11]), int(fields[12])
        out[int(tid)] = (comm, (utime + stime) / hz)
    return out


def main():
    n_reads = int(sys.argv[1]) if len(sys.argv) > 1 else 49152

    import bench as B
    from thermite.cli import enable_compile_cache

    enable_compile_cache()
    index = B._syn45_index()
    chrom = index.seq[index.refs[0].start_idx : index.refs[0].end_idx - 1]
    reads = B.make_reads(chrom, n_reads, seed=23)
    from thermite.align.batch import BatchAligner
    from thermite.align.driver import AlignOpts

    opts = AlignOpts(min_seed_len=20, min_aln_score_percent=0.0,
                     min_aln_score=30, intron_mode=True)
    ba = BatchAligner(index, opts)
    recs = [(b"r%d" % i, r, b"I" * len(r)) for i, r in enumerate(reads)]
    # warm at FULL size: compiles, sticky shape buckets, mmap faults,
    # and the pipeline-depth auto-decision all settle on pass 1
    ba.align_batch_emit(recs, fmt_bam=True)

    for trial in range(3):
        ba.stats.reset()
        before = thread_cpu()
        t0 = time.perf_counter()
        ba.align_batch_emit(recs, fmt_bam=True)
        wall = time.perf_counter() - t0
        after = thread_cpu()

        rows = []
        for tid, (comm, cpu) in after.items():
            prev = before.get(tid, (comm, 0.0))[1]
            d = cpu - prev
            if d > 0.005:
                rows.append((d, tid, comm))
        rows.sort(reverse=True)
        total = sum(r[0] for r in rows)
        print(f"trial {trial}: wall {wall:.3f} s   reads {n_reads}   "
              f"{n_reads/wall:.0f} reads/s   depth {ba.pipeline_depth}")
        print(f"  total thread CPU {total:.3f} s "
              f"({100*total/wall:.0f}% of wall; the rest is blocked waits)")
        for d, tid, comm in rows:
            main_tag = " [main]" if tid == os.getpid() else ""
            print(f"  {d:7.3f} s  {100*d/wall:5.1f}%  tid {tid:<8d} "
                  f"{comm}{main_tag}")
    print(ba.stats.report())


if __name__ == "__main__":
    main()
