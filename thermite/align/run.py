"""File-level alignment entry point: FASTQ(s) in, PAF/SAM/BAM out.

Mirrors reference src/aligner.rs:22-120.  The ``engine`` argument
selects the oracle (sequential, exact reference semantics) or the
batched device pipeline (``thermite.align.batch``).
"""

from __future__ import annotations

import sys
from typing import Iterable, Optional

from ..index.build import Index
from ..io.bam import BamWriter
from ..io.fastx import parse_fastx
from ..io.paf import paf_line
from ..io.sam import SamWriter, aln_to_sam_record, unmapped_sam_record
from .driver import AlignOpts, OracleAligner

FORMAT_PAF = "paf"
FORMAT_SAM = "sam"
FORMAT_BAM = "bam"


def _count_records(query_paths) -> int:
    """Cheap record count for shard bounds: raw buffered line/record
    scan (FASTQ = lines/4, FASTA = '>' lines) instead of a full
    ``parse_fastx`` pass — shard mode otherwise parses every input
    twice per host."""
    from ..io.fastx import _open

    total = 0
    for p in query_paths:
        with _open(p) as fh:
            first = fh.peek(1)[:1]
            if first == b">":
                while True:
                    block = fh.read(1 << 20)
                    if not block:
                        break
                    total += block.count(b"\n>")
                total += 1  # first record has no preceding newline
            else:
                lines = 0
                while True:
                    block = fh.read(1 << 20)
                    if not block:
                        break
                    lines += block.count(b"\n")
                total += (lines + 3) // 4
    return total


def align_reads_from_file(
    index: Index,
    query_paths: Iterable[str],
    output_path: str,
    output_fmt: str,
    opts: AlignOpts,
    engine: str = "oracle",
    batch_size: int = 16384,
    verbose: bool = False,
    profile_dir: Optional[str] = None,
    shard=None,
    mesh=None,
) -> None:
    """``shard=(host_id, num_hosts)`` makes this host align only its
    contiguous block of the input reads (parallel.multihost.shard_bounds
    — block sharding is order-preserving, so merging shard outputs in
    host order restores input order).  ``mesh`` is passed through to
    ``BatchAligner`` for local multi-chip data parallelism."""
    if profile_dir:
        import jax

        with jax.profiler.trace(profile_dir):
            align_reads_from_file(
                index, query_paths, output_path, output_fmt, opts,
                engine=engine, batch_size=batch_size, verbose=verbose,
                shard=shard, mesh=mesh,
            )
        return
    lo, hi = 0, None
    if shard is not None:
        from ..parallel.multihost import shard_bounds

        host_id, num_hosts = shard
        n = _count_records(query_paths)
        lo, hi = shard_bounds(n, num_hosts, host_id)

    def records():
        i = 0
        for path in query_paths:
            for rec in parse_fastx(path):
                if i >= lo and (hi is None or i < hi):
                    yield rec
                i += 1
    binary = output_fmt == FORMAT_BAM
    if output_path == "-":
        fh = sys.stdout.buffer if binary else sys.stdout
        close = False
    else:
        fh = open(output_path, "wb" if binary else "w")
        close = True

    try:
        if output_fmt == FORMAT_SAM:
            writer = SamWriter(fh, index)
        elif output_fmt == FORMAT_BAM:
            writer = BamWriter(fh, index)
        else:
            writer = None

        batcher = None
        if engine == "oracle":
            aligner = OracleAligner(index, opts)

            def aligned_records():
                for rec in records():
                    yield rec, aligner.align_read(rec.seq)

            results = aligned_records()
        elif engine == "batch":
            from .batch import BatchAligner

            batcher = BatchAligner(index, opts, mesh=mesh)

            import os

            if batcher.can_emit() and not os.environ.get("THERMITE_NO_EMIT"):
                # fast path: records serialized by the C++ emitter
                # straight from the finalize runs (byte-identical to
                # the Python writers by test); PAF rows included
                fmt_code = (
                    2 if output_fmt == FORMAT_PAF
                    else output_fmt == FORMAT_BAM
                )
                buf = []

                def flush():
                    raw = batcher.align_batch_emit(
                        [(r.id, r.seq, r.qual) for r in buf], fmt_code
                    )
                    if writer is not None:
                        writer.write_raw(raw)
                    else:  # PAF: text handle, no header
                        fh.write(raw.decode())

                for rec in records():
                    buf.append(rec)
                    if len(buf) >= batch_size:
                        flush()
                        buf = []
                if buf:
                    flush()
                if writer is not None:
                    writer.finish()
                if verbose:
                    print(batcher.stats.report(), file=sys.stderr)
                return

            def batched_records():
                buf = []
                for rec in records():
                    buf.append(rec)
                    if len(buf) >= batch_size:
                        yield from zip(buf, batcher.align_batch([r.seq for r in buf]))
                        buf = []
                if buf:
                    yield from zip(buf, batcher.align_batch([r.seq for r in buf]))

            results = batched_records()
        elif engine == "cpp":
            # all-native single-core pipeline (the honest baseline
            # engine; align/cpu.py) — emit-only surface
            if output_fmt not in (FORMAT_SAM, FORMAT_BAM):
                raise ValueError("--engine cpp writes SAM/BAM only")
            from .cpu import CppAligner

            cpp = CppAligner(index, opts, threads=0)  # auto: all cores
            buf = []

            def flush_cpp():
                raw = cpp.align_records(
                    [(r.id, r.seq, r.qual) for r in buf],
                    output_fmt == FORMAT_BAM,
                )
                writer.write_raw(raw)

            for rec in records():
                buf.append(rec)
                if len(buf) >= batch_size:
                    flush_cpp()
                    buf = []
            if buf:
                flush_cpp()
            writer.finish()
            if verbose:
                print(cpp.stats.report(), file=sys.stderr)
            return
        else:
            raise ValueError(f"unknown engine {engine!r}")

        for rec, alns in results:
            qual = rec.qual if rec.qual is not None else b""
            if not alns:
                if output_fmt in (FORMAT_SAM, FORMAT_BAM):
                    writer.write(unmapped_sam_record(rec.id, rec.seq, qual))
                continue
            for i, aln in enumerate(alns):
                if output_fmt in (FORMAT_SAM, FORMAT_BAM):
                    writer.write(
                        aln_to_sam_record(
                            index, rec.id, rec.seq, qual, aln, len(alns), i + 1
                        )
                    )
                else:
                    fh.write(paf_line(rec.id, rec.seq, aln, len(alns)) + "\n")

        if writer is not None:
            writer.finish()
        if verbose and batcher is not None:
            print(batcher.stats.report(), file=sys.stderr)
    finally:
        if close:
            fh.close()
