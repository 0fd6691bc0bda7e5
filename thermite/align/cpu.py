"""All-native single-core CPU engine: the honest baseline.

``CppAligner`` runs the ENTIRE pipeline in C++ on one thread — seeding,
chunk build, scalar banded SWG (csrc swg_stream_row, the exact mirror
of reference src/swg.rs:31-240), arbitration, finalize, and record
emission — with zero device involvement.  It exists to anchor the
"vs single-core" speedup claim fairly: the reference is compiled Rust
at opt-level 3 (reference Cargo.toml:33-41), so comparing the device
pipeline against the *Python* oracle would flatter it by an order of
magnitude.  Output is byte-identical to the batch device emit path
(tests/test_cpu_engine.py).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .driver import AlignOpts
from ..index.build import Index


def _round_up(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


class CppAligner:
    PROBLEM_BUDGET = 32768 - 1024

    def __init__(self, index: Index, opts: AlignOpts, threads: int = 1):
        # reuse the batch pipeline's engine assembly (seeder, interval
        # tables, string tables) — the device side stays untouched
        from .batch import BatchAligner

        self._ba = BatchAligner(
            index, opts, use_native=True
        )
        if self._ba.native is None:
            raise RuntimeError("native library unavailable for --engine cpp")
        self.native = self._ba.native
        self.index = index
        self.opts = opts
        # threads=1 is the honest single-core baseline (what bench.py
        # measures); threads>1 parallelizes the scalar-DP loop over
        # problems — the production CPU mode (the reference's own
        # concurrency contract is caller-threading over a shared index,
        # src/wrapper.rs:20-27, which a GIL-bound caller cannot give
        # the C++ engine).  threads<=0 = auto: THERMITE_THREADS, else
        # hardware concurrency.  Output is thread-count-invariant
        # (tests/test_cpu_engine.py).
        import os

        if threads <= 0:
            threads = int(
                os.environ.get("THERMITE_THREADS", os.cpu_count() or 1)
            )
        self.threads = max(threads, 1)
        # same adaptive narrow-band pass as the device pipeline
        # (certificate-gated, bit-identical; THERMITE_NARROW_BAND=0
        # disables) — keeps the single-core baseline algorithmically
        # honest vs the device path
        import os

        self.narrow_band = int(os.environ.get("THERMITE_NARROW_BAND", "15"))
        from ..utils.stats import PipelineStats

        self.stats = PipelineStats()

    def align_records(
        self, recs: List[Tuple[bytes, bytes, bytes]], fmt_bam: bool,
        strip_tags: bool = False,
    ) -> bytes:
        """(name, seq, qual) tuples -> serialized SAM/BAM record bytes
        in input order (>= 1 record per read)."""
        from ..ops.layout import _WPAD

        lib = self.native._lib
        out: List[bytes] = []
        pos = 0
        while pos < len(recs):
            take = min(len(recs) - pos, 16384)
            sl = recs[pos : pos + take]
            reads = [r[1].upper() for r in sl]
            rpad = _round_up(max((len(r) for r in reads), default=1), 32)
            maxlen = max((len(r) for r in reads), default=1)
            pw = (3 * maxlen + 20) // 16 + 1
            reads_pad = np.zeros((take, rpad), np.uint8)
            lens = np.zeros(take, np.int64)
            for i, r in enumerate(reads):
                reads_pad[i, : len(r)] = np.frombuffer(r, np.uint8)
                lens[i] = len(r)
            import ctypes

            _u8p = ctypes.POINTER(ctypes.c_uint8)
            _i64p = ctypes.POINTER(ctypes.c_int64)
            # restype/argtypes are declared in native_batch._setup
            patches = ctypes.c_int64(0)
            ch = lib.thermite_chunk_align_cpu_mt(
                self.native._h,
                reads_pad.ctypes.data_as(_u8p), take, rpad,
                lens.ctypes.data_as(_i64p), self.PROBLEM_BUDGET,
                _WPAD, pw, self.narrow_band,
                ctypes.cast(ctypes.byref(patches), _i64p), 0, self.threads,
            )
            self.stats.cert_patches += patches.value
            if not ch:
                raise RuntimeError("native cpu chunk pipeline failed")
            consumed = lib.thermite_chunk_n_reads(ch)
            self.stats.reads += consumed
            self.stats.chunks += 1
            self.stats.problems += lib.thermite_chunk_n_problems(ch)
            raw = self.native.emit_chunk(
                ch, fmt_bam,
                [r[0] for r in sl[:consumed]],
                [r[1] for r in sl[:consumed]],
                [r[2] or b"" for r in sl[:consumed]],
                strip_tags=strip_tags,
            )
            self.native.free_chunk(ch)
            if raw is None:
                raise RuntimeError("native cpu emit fell back unexpectedly")
            out.append(raw)
            pos += consumed
        return b"".join(out)

    def align_records_paired(
        self,
        pair_recs,
        fmt_bam: bool,
        max_insert: int = 1000,
        mate_rescue: bool = True,
        strip_tags: bool = False,
    ) -> bytes:
        """Paired-end single-core pipeline: ``pair_recs`` is a list of
        ((name, seq, qual) R1, (name, seq, qual) R2) byte tuples ->
        serialized SAM/BAM record bytes with mate fields, in pair
        order.  Pairing runs in C++ (thermite_chunk_pair) on chunks
        built with pair-aligned consumption; mate-rescue pairs come
        back as splice points whose alignments are recomputed by the
        OracleAligner (identical lists to the engine's by the existing
        parity tests) and serialized via pair_records + the Python
        writers — the same composition the device paired emit path uses."""
        import ctypes

        from ..io.bam import encode_bam_record
        from ..io.sam import unique_refs
        from ..ops.layout import _WPAD
        from .paired import pair_records

        lib = self.native._lib
        rescue_opts = self.opts if mate_rescue else None
        ref_ids = {
            n: i for i, (n, _) in enumerate(unique_refs(self.index))
        }
        oracle = None
        _STRIP = {"TX", "GX", "GN", "RE"}

        class _R:
            __slots__ = ("id", "seq", "qual")

            def __init__(self, rid, seq, qual):
                self.id, self.seq, self.qual = rid, seq, qual

        def ser_pair(rec1, rec2) -> bytes:
            nonlocal oracle
            if oracle is None:
                from .driver import OracleAligner

                oracle = OracleAligner(self.index, self.opts)
            alns1 = oracle.align_read(rec1[1])
            alns2 = oracle.align_read(rec2[1])
            parts = []
            for rec in pair_records(
                self.index, _R(rec1[0], rec1[1], rec1[2] or b""),
                _R(rec2[0], rec2[1], rec2[2] or b""), alns1, alns2,
                max_insert, rescue_opts=rescue_opts,
            ):
                if strip_tags:
                    rec.tags = [t for t in rec.tags if t[0] not in _STRIP]
                parts.append(
                    encode_bam_record(rec, ref_ids) if fmt_bam
                    else (rec.to_line() + "\n").encode()
                )
            return b"".join(parts)

        recs = []
        for r1, r2 in pair_recs:
            recs.append(r1)
            recs.append(r2)
        _u8p = ctypes.POINTER(ctypes.c_uint8)
        _i64p = ctypes.POINTER(ctypes.c_int64)
        out: List[bytes] = []
        pos = 0
        while pos < len(recs):
            take = min(len(recs) - pos, 16384)
            if take % 2:  # never offer a half pair
                take += 1 if pos + take < len(recs) else -1
            sl = recs[pos : pos + take]
            reads = [r[1].upper() for r in sl]
            rpad = _round_up(max((len(r) for r in reads), default=1), 32)
            maxlen = max((len(r) for r in reads), default=1)
            pw = (3 * maxlen + 20) // 16 + 1
            reads_pad = np.zeros((take, rpad), np.uint8)
            lens = np.zeros(take, np.int64)
            for i, r in enumerate(reads):
                reads_pad[i, : len(r)] = np.frombuffer(r, np.uint8)
                lens[i] = len(r)
            patches = ctypes.c_int64(0)
            ch = lib.thermite_chunk_align_cpu_mt(
                self.native._h,
                reads_pad.ctypes.data_as(_u8p), take, rpad,
                lens.ctypes.data_as(_i64p), self.PROBLEM_BUDGET,
                _WPAD, pw, self.narrow_band,
                ctypes.cast(ctypes.byref(patches), _i64p), 1, self.threads,
            )
            self.stats.cert_patches += patches.value
            if not ch:
                raise RuntimeError("native cpu chunk pipeline failed")
            consumed = lib.thermite_chunk_n_reads(ch)
            assert consumed % 2 == 0
            self.stats.reads += consumed
            self.stats.chunks += 1
            self.stats.problems += lib.thermite_chunk_n_problems(ch)
            self.native.pair_chunk(ch, max_insert, mate_rescue)
            raw = self.native.emit_chunk(
                ch, fmt_bam,
                [r[0] for r in sl[:consumed]],
                [r[1] for r in sl[:consumed]],
                [r[2] or b"" for r in sl[:consumed]],
                strip_tags=strip_tags,
            )
            if raw is None:
                raise RuntimeError("native cpu emit fell back unexpectedly")
            pairs_idx, offs = self.native.splices(ch)
            self.native.free_chunk(ch)
            base = pos // 2
            parts = []
            prev = 0
            for p, off in zip(pairs_idx.tolist(), offs.tolist()):
                parts.append(raw[prev:off])
                parts.append(ser_pair(*pair_recs[base + p]))
                prev = off
            parts.append(raw[prev:])
            out.append(b"".join(parts))
            pos += consumed
        return b"".join(out)
