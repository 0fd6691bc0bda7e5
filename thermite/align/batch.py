"""Batched device alignment pipeline.

Same observable semantics as the oracle driver
(``thermite.align.driver``, reference src/aligner.rs:123-314) but
restructured for batched device execution:

1. **Build** (C++ engine): seed every read, derive extension problems
   as 9-int32 gather offsets into the device-resident reference text.
2. **One device pass per chunk**: the stream kernel (``ops/stream.py``)
   scores every nontrivial problem AND walks its traceback, returning a
   pid-indexed
   ``[score, max cell, packed 2-bit op stream]`` row set (losers' walks
   are cheap; empty-flank problems have known results and never reach
   the device).
3. **Arbitrate** (C++/host) using scores + spans only (span-only
   lifting, filter thresholds, genome-vs-transcriptome choice, overlap
   filter, primary selection — all rules identical to the oracle).
4. **Finalize** (C++/host) only the winners: decode streams, stitch,
   lift through exons, flip '-'-strand coords, and emit final
   GenomeAlignments (with RLE op runs attached for fast writers).

Why batching at a fixed band is exact (vs the reference's sequential
band narrowing, src/aligner.rs:162-172): narrowing only prunes — an
alignment retained by the final filter (score >= final_max - range)
always fits inside the narrowed band/x-drop budget, and alignments it
would have pruned early (score < running_max - range) are removed by
the same final filter anyway.  The per-read parity tests in
tests/test_batch_parity.py verify this equivalence empirically.

Routes: "stream" (the single-pass pipeline above; needs the native
engine) on every platform, or "xla" (a two-pass test path: lax.scan
forward kernel + host traceback, with or without the native engine).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import MATCH_SCORE
from ..index.build import Index
from ..index.span_lift import lift_tx_span_to_gx
from ..index.txome import lift_mem_to_tx, lift_tx_to_gx
from ..ops.stream import smax_for, width_for_band
from .driver import AlignOpts, concat_to_chr_aln, filter_overlapping
from .extend import extend_seed_match, stitch
from .types import (
    Alignment,
    EXONIC,
    GenomeAlignment,
    INTERGENIC,
    INTRONIC,
    Mem,
    RunOps,
)


def _round_up(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


def _pow2_bucket(n: int, lo: int) -> int:
    """Pad batch size to a power-of-two bucket (bounded distinct shapes
    -> bounded kernel recompiles, <=2x padding waste)."""
    m = lo
    while m < n:
        m *= 2
    return m


class _Problems:
    """Offset-encoded extension problems (SoA).

    No window bytes are materialised on host: a problem is 9 int32s
    (``ops.layout.META_COLS`` layout) indexing the device-resident
    nibble-packed reference text and padded read block; the x/y windows
    are gathered on-device instead of shipped from the host.  The y
    anchor is split into (word, sub-offset) on the host so every device
    quantity stays int32 up to ~17 Gbp texts (whole genome without
    64-bit JAX).
    """

    __slots__ = ("rows", "_meta")

    def __init__(self):
        self.rows: List[Tuple[int, ...]] = []
        self._meta: Optional[np.ndarray] = None

    def add(self, y_base, y_dir, ylen, x_base, x_dir, xlen, band, x_drop) -> int:
        from ..ops.layout import _WPAD

        lo = y_base + _WPAD
        self.rows.append(
            (lo >> 3, lo & 7, y_dir, ylen, x_base, x_dir, xlen, band, x_drop)
        )
        return len(self.rows) - 1

    def meta(self) -> np.ndarray:
        if self._meta is None or len(self._meta) != len(self.rows):
            self._meta = np.asarray(self.rows, np.int32).reshape(len(self.rows), 9)
        return self._meta

    def __len__(self):
        return len(self.rows)


@dataclass
class _ChunkState:
    """Per-chunk pipeline state flowing through build -> device ->
    arbitrate -> finalize."""

    reads: List[bytes]
    problems: "_Problems" = field(default_factory=lambda: _Problems())
    tasks: List["_Task"] = field(default_factory=list)
    read_params: List[Tuple[int, int, int]] = field(default_factory=list)
    per_read_tasks: List[List["_Task"]] = field(default_factory=list)
    selected: List[List[Tuple[GenomeAlignment, "_Task"]]] = field(
        default_factory=list
    )
    reads_host: Optional[np.ndarray] = None
    reads_dev: object = None
    meta_all: Optional[np.ndarray] = None  # (P, 8) problem offsets
    fwd_idx: Optional[np.ndarray] = None  # rows sent to device (nontrivial)
    tb_idx: Optional[np.ndarray] = None
    fwd_raw: object = None  # un-synced device output of the forward pass
    pid_list: object = None  # winner problem ids (list or int64 array)
    tb_raw: object = None  # un-synced device output of the traceback pass
    tb_meta_sub: Optional[np.ndarray] = None
    # native-engine state
    native_ch: object = None
    tasks_arr: Optional[np.ndarray] = None  # (T, 10) int64
    selected_arr: Optional[np.ndarray] = None  # (S, 11) int64
    tb_full: Optional[np.ndarray] = None  # pid-indexed stream rows
    # winners-only stream transfer (single-pass split pipeline)
    fwd_streams: object = None  # device-resident (Nb, PW) op streams
    inv_rows: Optional[np.ndarray] = None  # pid -> device row (-1 none)
    patched: Optional[np.ndarray] = None  # pids host-patched at full band
    gather_raw: object = None  # un-synced winners' stream gather
    gather_pids: Optional[np.ndarray] = None


@dataclass
class _Task:
    read_i: int
    kind: str  # 'gx' | 'tx'
    hit: Mem  # window-relative (gx) or tx-relative (tx)
    left_pid: int
    right_pid: int
    ref_len: int  # window length (gx) or len(tx.seq)
    seq_start: int = 0  # gx: window start in concatenated coords
    abs_hit: Optional[Mem] = None  # gx: absolute hit (for classification)
    tx_idx: int = -1
    # filled after scoring:
    score: int = 0
    span: Tuple[int, int, int, int] = (0, 0, 0, 0)  # ystart, yend, xstart, xend


class BatchAligner:
    def __init__(
        self,
        index: Index,
        opts: AlignOpts,
        backend: Optional[str] = None,
        use_native: Optional[bool] = None,
        mesh=None,
    ):
        # mesh: a jax.sharding.Mesh with a "data" axis — the multi-device
        # mode: the resident text and read block replicate into every
        # device's memory, extension problems shard on rows, and each
        # device runs the single-pass gather+DP+traceback step on its
        # shard (parallel/mesh.py sharded_stream_kernel).  Output rows
        # come back in input order, so every host stage downstream is
        # unchanged — byte-identical results by test.
        self.mesh = mesh
        # route: "stream" (single pass, native engine required) unless
        # the caller opts out of the native engine or asks for the
        # two-pass "xla" test path by name
        if backend is None:
            backend = "xla" if use_native is False else "stream"
        if backend not in ("stream", "xla"):
            raise ValueError(f"unknown backend {backend!r} (stream | xla)")
        if backend == "stream" and use_native is False:
            raise ValueError("the stream route needs the native engine")
        self.backend = backend
        # batch rows pad to a multiple of n_devices under a mesh
        # (shard_map splits rows evenly)
        self._nsh = 1 if mesh is None else int(np.prod(mesh.devices.shape))
        self.index = index
        self.opts = opts
        from ..seed.native import make_seeder

        self.seeder = make_seeder(
            index.seq_arr, opts.min_seed_len,
            table=getattr(index, "seed_table", None),
            stride_known=getattr(index, "seed_stride", None),
        )
        # adaptive narrow-band pass (single-pass stream route only):
        # extension problems are submitted at band min(band, narrow_band)
        # and the kernel emits a per-problem exactness certificate
        # (nsteps = -2 on failure); failures are recomputed exactly at
        # the ORIGINAL band by the C++ scalar oracle and spliced into
        # the device output, so every downstream stage sees bit-exact
        # full-band results.  0 disables.  The default band at -s0
        # (90 bp reads) is 60 -> ~3x fewer DP cells at band 15, with
        # patch rates well under 1% on real reads (a flank certifies
        # with up to (narrow_band+1)/2 mismatches).
        self.narrow_band = int(os.environ.get("THERMITE_NARROW_BAND", "15"))
        # pipeline depth: 2 overlaps device kernels with host work; on a
        # single-core host the device runtime's polling thread contends
        # with long host builds (large genomes), where serializing wins.
        # None = decide from the first (uncontended) chunk build time.
        # THERMITE_PIPELINE_DEPTH forces a value (A/B and ops knob).
        _pd = os.environ.get("THERMITE_PIPELINE_DEPTH", "")
        self.pipeline_depth: Optional[int] = int(_pd) if _pd else None
        # chunk problem budget (ops/A-B knob): bigger chunks amortize
        # the per-chunk fixed costs (two device syncs + kernel
        # dispatch) over more reads, at the price of a new kernel batch
        # shape (N doubles) and a longer pipeline fill/drain tail.
        # Default = class value (just under the 64k power-of-two
        # bucket).
        _pb = os.environ.get("THERMITE_PROBLEM_BUDGET", "")
        if _pb:
            self.PROBLEM_BUDGET = int(_pb)
        from ..utils.stats import PipelineStats

        self.stats = PipelineStats()

        # resident reference text: concatenated genome (fwd+rc, with $
        # sentinels) followed by every transcript's spliced sequence.
        txs = index.txome.txs
        self.tx_off = np.zeros(len(txs) + 1, np.int64)
        base = len(index.seq_arr)
        for i, tx in enumerate(txs):
            self.tx_off[i] = base
            base += len(tx.seq)
        self.tx_off[len(txs)] = base
        rt = getattr(index, "ref_text_arr", None)
        if rt is not None and len(rt) == self.tx_off[len(txs)]:
            # artifact-resident text (genome + txs, exactly this
            # layout): reuse the mmap view — at genome scale the
            # concatenate below is a ~6.5 GB first-touch copy
            self._ref_text_host = np.asarray(rt)
        else:
            self._ref_text_host = np.concatenate(
                [index.seq_arr]
                + [np.frombuffer(tx.seq, np.uint8) for tx in txs]
            )
        self._ref_text_dev = None  # device copy, uploaded once on first use
        if self.backend != "stream" and len(self._ref_text_host) >= (1 << 31):
            # the XLA test backend reconstructs byte offsets in int32
            # (swg_batch.gather_windows_bytes); only the nibble-packed
            # stream route carries whole-genome texts
            raise NotImplementedError(
                "the xla backend is limited to <2 GiB reference text; "
                "use the stream route for whole-genome scale"
            )
        if self.backend == "stream" and not getattr(
            index, "text_acgtn_ok", False
        ):
            # the nibble-packed device text has 4-bit codes for ACGTN$
            # only; any other byte would lose its identity (the
            # reference's byte compare would let e.g. R match R).  Real
            # genomes are ACGTN — fail loudly on anything else.  An
            # artifact whose save-time scan passed records that in meta
            # (text_acgtn_ok), sparing the full-text pass here.
            # chunked: np.bincount casts its input to int64 first, so a
            # single call over a genome-scale text materializes 8x the
            # text in fresh anonymous pages (52 GB at 6.5 GB).  Cast
            # into ONE preallocated buffer so every chunk re-writes the
            # same pages instead of bincount mmap-ing a fresh temp per
            # call.
            from ..index.build import acgtn_counts

            counts = acgtn_counts(self._ref_text_host)
            counts[list(b"ACGTN$") + [0]] = 0
            if counts.sum():
                bad = [chr(b) for b in np.flatnonzero(counts)[:5]]
                raise NotImplementedError(
                    "reference text contains non-ACGTN$ bytes "
                    f"({bad}...): the nibble-packed device text cannot "
                    "represent them; sanitize the FASTA or use the "
                    "xla backend"
                )

        # native (C++) build/arbitrate engine; the Python stages below
        # serve the two-pass xla test path and stay the parity referee
        self.native = None
        if use_native is not False:
            try:
                from ..seed.kmer import MAX_ANCHOR_K
                from .native_batch import NativeBatchEngine

                self.native = NativeBatchEngine(
                    index, opts, self.tx_off, self._ref_text_host,
                    opts.min_seed_len, min(MAX_ANCHOR_K, opts.min_seed_len),
                    seeder=self.seeder if hasattr(self.seeder, "_h") else None,
                )
            except (RuntimeError, AttributeError, OSError) as e:
                if use_native or self.backend == "stream":
                    from ..seed.native import load_error

                    raise RuntimeError(
                        f"the {self.backend} route needs the native engine, "
                        f"which failed to load: {e} {load_error}".rstrip()
                    ) from e
                self.native = None

    def _reads_bucket(self, n: int) -> int:
        """Sticky row bucket for the padded read block: a short trailing
        chunk pads up to the largest bucket seen instead of introducing a
        new jit input shape (each fresh shape costs a full compile)."""
        b = max(_pow2_bucket(max(n, 1), 256), getattr(self, "_NREADS", 0))
        self._NREADS = b
        return b

    def _ref_text(self):
        """Device-resident nibble-packed reference text: ((Lw,) int32, Lw).

        Packed on the host (L/2 bytes uploaded once — a 6.2 Gbp fwd+rc
        whole-genome text is 3.1 GB of device memory)."""
        if self._ref_text_dev is None:
            from ..ops.layout import nib_lw, pack_text_nib_host

            lw = nib_lw(len(self._ref_text_host))
            nib = getattr(self.index, "text_nib_arr", None)
            if nib is None or len(nib) != lw:
                # artifact carries no packed form (or a stale pad):
                # pack on the host — a ~L/2-byte fresh buffer
                nib = pack_text_nib_host(self._ref_text_host)
            words = jax.device_put(nib, self._sharding_repl())
            self._ref_text_dev = (words, np.int32(lw))
        return self._ref_text_dev

    def _sharding_repl(self):
        """Replicated placement under a mesh; default device otherwise."""
        if self.mesh is None:
            return None
        from jax.sharding import NamedSharding, PartitionSpec

        return NamedSharding(self.mesh, PartitionSpec())

    # ------------------------------------------------------------------
    # The batch is processed in chunks through a 3-stage software
    # pipeline: build (host) -> forward+traceback (device, dispatched
    # asynchronously) -> arbitrate/finalize (host).  While the device
    # runs chunk k's kernels the host builds chunk k+1 and finalizes
    # chunk k-1, so device time largely disappears behind host time
    # (JAX dispatch is async; np.asarray is the sync point).
    #
    # Chunks are cut by *problem count*, just under the kernel's
    # power-of-two batch bucket, so padding waste stays a few percent
    # (cutting by read count can overshoot a bucket boundary and
    # double the padded batch).  Each chunk pays two device syncs plus
    # kernel dispatch; THERMITE_PROBLEM_BUDGET overrides for A/B or
    # memory-constrained deployments.
    PROBLEM_BUDGET = 65536 - 2048

    def align_batch(self, reads: List[bytes]) -> List[List[GenomeAlignment]]:
        out: List[List[GenomeAlignment]] = []
        self._pipeline(reads, lambda st, s0: out.extend(self._finalize_chunk(st)))
        return out

    def can_emit(self) -> bool:
        """True when the C++ record emitter serves this configuration
        (native engine + the single-pass stream route)."""
        return self.native is not None and self.backend == "stream"

    def align_batch_emit(self, recs, fmt_bam: bool, strip_tags: bool = False):
        """Serialize-as-you-go batch alignment: ``recs`` is a list of
        (name, seq, qual) byte tuples; returns the concatenated output
        record bytes (SAM text lines or BAM record blobs, no header) in
        input order.  Records are emitted by the C++ engine straight
        from the finalize runs (reference src/aln_writer.rs:118-238 via
        io/sam.py semantics); any chunk whose stream needed a host
        fallback is serialized by the Python writers instead —
        byte-identical either way (tests/test_emit.py).  ``strip_tags``
        drops TX/GX/GN/RE (the embedding wrapper surface)."""
        chunks: List[bytes] = []

        def fin(st, start):
            raw = None
            if (
                st.native_ch is not None
                and self.backend == "stream"
                and st.tb_full is not None
            ):
                tb_out = self._take_tb(st)
                self.native.finalize(st.native_ch, tb_out, st.meta_all)
                sl = recs[start : start + len(st.reads)]
                raw = self.native.emit_chunk(
                    st.native_ch, fmt_bam,
                    [r[0] for r in sl],
                    [r[1] for r in sl],
                    [r[2] or b"" for r in sl],
                    strip_tags=strip_tags,
                )
                if raw is not None:
                    self.native.free_chunk(st.native_ch)
                    st.native_ch = None
                    chunks.append(raw)
                    return
                st.tb_full = tb_out  # fall back to the object path
            results = self._finalize_chunk(st)
            chunks.append(
                _serialize_records(
                    self.index, recs[start : start + len(results)], results,
                    fmt_bam, strip_tags=strip_tags,
                )
            )

        self._pipeline([r[1] for r in recs], fin)
        return b"".join(chunks)

    def align_paired_emit(
        self, pair_recs, fmt_bam: bool, max_insert: int = 1000,
        mate_rescue: bool = True, strip_tags: bool = False,
    ) -> bytes:
        """Paired-end serialize-as-you-go alignment through the C++
        emitter.  ``pair_recs`` is a list of ((name, seq, qual) R1,
        (name, seq, qual) R2) byte-tuple pairs; returns concatenated
        SAM/BAM record bytes (no header) in input-pair order with mate
        fields filled (FLAG 0x1/0x2/0x8/0x20/0x40/0x80, RNEXT/PNEXT/
        TLEN — align/paired.py pair_records semantics).

        Both mates ride ONE interleaved device batch; the FR pairing
        decision runs in C++ (``thermite_chunk_pair``, the twin of
        paired.py select_pair) and records are serialized by the C++
        emitter.  Pairs needing mate rescue (exactly one unmapped mate
        — re-seeding is host-side by design) come back as splice
        points: their records are computed by pair_records + the
        Python writers and spliced into the C++ byte stream.  Output is
        byte-identical to the pure-Python paired path by
        tests/test_paired_emit.py."""
        from collections import namedtuple

        from ..io.sam import unique_refs
        from .paired import pair_records as _pair_records

        Rec = namedtuple("Rec", ["id", "seq", "qual"])
        recs: List = []
        for r1, r2 in pair_recs:
            recs.append(r1)
            recs.append(r2)
        rescue_opts = self.opts if mate_rescue else None
        ref_ids = {n: i for i, (n, _) in enumerate(unique_refs(self.index))}
        chunks: List[bytes] = []

        _STRIP = {"TX", "GX", "GN", "RE"}

        def ser_pair(rec1, rec2, alns1, alns2) -> bytes:
            from ..io.bam import encode_bam_record

            out = []
            for rec in _pair_records(
                self.index, Rec(*rec1), Rec(*rec2), alns1, alns2,
                max_insert, rescue_opts=rescue_opts,
            ):
                if strip_tags:
                    rec.tags = [t for t in rec.tags if t[0] not in _STRIP]
                out.append(
                    encode_bam_record(rec, ref_ids) if fmt_bam
                    else (rec.to_line() + "\n").encode()
                )
            return b"".join(out)

        def fin(st, start):
            if (
                st.native_ch is not None
                and self.backend == "stream"
                and st.tb_full is not None
            ):
                tb_out = self._take_tb(st)
                fin_data = self.native.finalize(
                    st.native_ch, tb_out, st.meta_all
                )
                self.native.pair_chunk(st.native_ch, max_insert, mate_rescue)
                sl = recs[start : start + len(st.reads)]
                raw = self.native.emit_chunk(
                    st.native_ch, fmt_bam,
                    [r[0] for r in sl], [r[1] for r in sl],
                    [r[2] or b"" for r in sl],
                    strip_tags=strip_tags,
                )
                if raw is not None:
                    pairs_idx, offs = self.native.splices(st.native_ch)
                    self.native.free_chunk(st.native_ch)
                    st.native_ch = None
                    # test/telemetry counters: C++-emitted chunks and
                    # Python-spliced (mate rescue) pairs
                    self.stats.emit_cpp_chunks = (
                        getattr(self.stats, "emit_cpp_chunks", 0) + 1
                    )
                    self.stats.spliced_pairs = (
                        getattr(self.stats, "spliced_pairs", 0)
                        + len(pairs_idx)
                    )
                    if len(pairs_idx) == 0:
                        chunks.append(raw)
                        return
                    # materialize objects ONLY for the spliced pairs
                    want = set()
                    for p in pairs_idx.tolist():
                        want.add(2 * p)
                        want.add(2 * p + 1)
                    results = [[] for _ in st.reads]
                    self._objects_from_native(st, fin_data, results, want)
                    base = start // 2
                    parts: List[bytes] = []
                    prev = 0
                    for p, off in zip(pairs_idx.tolist(), offs.tolist()):
                        parts.append(raw[prev:off])
                        r1, r2 = pair_recs[base + p]
                        parts.append(
                            ser_pair(
                                r1, r2, results[2 * p], results[2 * p + 1]
                            )
                        )
                        prev = off
                    parts.append(raw[prev:])
                    chunks.append(b"".join(parts))
                    return
                st.tb_full = tb_out  # fall back to the object path
            results = self._finalize_chunk(st)
            self.stats.emit_py_chunks = (
                getattr(self.stats, "emit_py_chunks", 0) + 1
            )
            # pair-aligned consumption guarantees both (C++ and Python
            # builds); a violation here would silently mispair the rest
            assert start % 2 == 0 and len(results) % 2 == 0
            base = start // 2
            out = []
            for p in range(len(results) // 2):
                r1, r2 = pair_recs[base + p]
                out.append(
                    ser_pair(r1, r2, results[2 * p], results[2 * p + 1])
                )
            chunks.append(b"".join(out))

        self._paired_build = True
        try:
            self._pipeline([r[1] for r in recs], fin)
        finally:
            self._paired_build = False
        return b"".join(chunks)

    def _pin_shapes(self, reads: List[bytes]) -> None:
        """Raise every sticky kernel-shape bucket to its batch
        worst-case UP FRONT, so one aligner configuration compiles
        exactly ONE stream-kernel shape set.  Without this, sticky
        buckets grow chunk by chunk (band/window/step maxima, problem
        and read-row buckets) and each growth recompiles the kernel.
        Small batches skip the pinning (padding a 100-problem batch to
        the full budget would waste more than it saves)."""
        if len(reads) * 4 < self.PROBLEM_BUDGET:
            return
        maxlen = max(map(len, reads), default=1)
        ms = max(
            int(self.opts.min_aln_score_percent * float(maxlen)),
            self.opts.min_aln_score,
        )
        # per-read band = len - max(pct*len, min_score) is maximized at
        # maxlen (the subtracted term grows at most as fast as len)
        band = max(maxlen - ms, 1)
        # the adaptive narrow-band pass submits problems at the capped
        # band, so the kernel shapes (YMAX/W) pin to the narrowed
        # worst case; SMAX still covers ORIGINAL-band walks (host cert
        # patches write full-band streams into the same rows)
        kband = band
        if self.narrow_band > 0 and self.backend == "stream":
            kband = min(band, self.narrow_band)
        self._XMAX = max(_round_up(maxlen, 32), getattr(self, "_XMAX", 0))
        self._YMAX = max(
            _round_up(maxlen + kband + 1, 32), getattr(self, "_YMAX", 0)
        )
        self._W = max(width_for_band(kband), getattr(self, "_W", 0))
        # device rows carry narrow-band walks only; original-band cert
        # patches land in the wider host array (_SMAX_HOST)
        self._SMAX = max(
            _round_up(maxlen + (maxlen + kband + 1) + 2, 16),
            getattr(self, "_SMAX", 0),
        )
        self._SMAX_HOST = max(
            _round_up(maxlen + (maxlen + band + 1) + 2, 16),
            self._SMAX, getattr(self, "_SMAX_HOST", 0),
        )
        nb = _pow2_bucket(self.PROBLEM_BUDGET + 1024, 128)
        for attr in ("_NFWD1", "_NFWD", "_NTB"):
            setattr(self, attr, max(nb, getattr(self, attr, 0)))
        self._NREADS = max(
            _pow2_bucket(min(len(reads), self.PROBLEM_BUDGET), 256),
            getattr(self, "_NREADS", 0),
        )

    def _pipeline(self, reads: List[bytes], finalize_fn) -> None:
        """The 3-stage chunk loop; ``finalize_fn(st, start_read_index)``
        consumes each chunk in input order.

        The generational GC is paused for the duration of the batch:
        finalize retains hundreds of thousands of small container
        objects (alignments, op-run lists), and every gen-0 collection
        the allocator triggers re-traverses the survivors — measured
        3.7x on object construction (4.9 -> 1.3 us per selected
        alignment at chrM bench scale).  One deferred collection after
        the batch pays the traversal once instead of dozens of times."""
        import gc

        gc_was_enabled = gc.isenabled()
        if gc_was_enabled:
            gc.disable()
        try:
            self._pipeline_inner(reads, finalize_fn)
        finally:
            if gc_was_enabled:
                gc.enable()

    def _pipeline_inner(self, reads: List[bytes], finalize_fn) -> None:
        built: List[Optional["_ChunkState"]] = []
        starts: List[int] = []
        arb_i = 0
        fin_i = 0
        i = 0
        # one O(N) scan raises the sticky read pad for the whole batch
        # (per-chunk rescans would be O(N x chunks))
        self._RPAD = max(
            _round_up(max(map(len, reads), default=1), 32),
            getattr(self, "_RPAD", 0),
        )
        self._pin_shapes(reads)
        while i < len(reads) or not built:
            with self.stats.stage("build"):
                starts.append(i)
                st, i = self._build_chunk(reads, i)
            self._dispatch_forward(st)
            if self.backend == "stream" and st.fwd_raw is not None:
                # start the d2h transfer the moment the kernel finishes
                # (it queues behind the kernel on the device stream), so
                # the headers cross while the host builds the NEXT chunk
                # instead of serializing inside the arbitrate sync
                try:
                    st.fwd_raw.copy_to_host_async()
                except AttributeError:
                    pass
            self.stats.chunks += 1
            self.stats.reads += len(st.reads)
            self.stats.problems += len(st.meta_all)
            if st.tasks_arr is not None:
                self.stats.tasks += len(st.tasks_arr)
            else:
                self.stats.tasks += len(st.tasks)
            built.append(st)
            depth = self.pipeline_depth or 2
            if len(built) - arb_i >= depth:
                with self.stats.stage("arbitrate"):
                    self._arbitrate_chunk(built[arb_i])
                arb_i += 1
            if arb_i - fin_i >= depth:
                with self.stats.stage("finalize"):
                    finalize_fn(built[fin_i], starts[fin_i])
                built[fin_i] = None
                fin_i += 1
        while arb_i < len(built):
            with self.stats.stage("arbitrate"):
                self._arbitrate_chunk(built[arb_i])
            arb_i += 1
        while fin_i < len(built):
            with self.stats.stage("finalize"):
                finalize_fn(built[fin_i], starts[fin_i])
            built[fin_i] = None
            fin_i += 1

    # ------------------------------------------------------------------
    def _build_chunk(
        self, all_reads: List[bytes], start: int
    ) -> Tuple["_ChunkState", int]:
        if self.native is not None:
            return self._build_chunk_native(all_reads, start)
        opts = self.opts
        index = self.index
        RPAD = self._RPAD

        reads: List[bytes] = []
        st = _ChunkState(reads=reads)
        problems = st.problems
        tasks = st.tasks
        read_params = st.read_params
        per_read_tasks = st.per_read_tasks

        pos = start
        # paired builds only cut at pair boundaries (align_paired_emit
        # relies on both mates sharing a chunk; the native build applies
        # the same rule in C++)
        paired = getattr(self, "_paired_build", False)
        while pos < len(all_reads) and (
            len(problems) < self.PROBLEM_BUDGET
            or (paired and len(reads) % 2)
        ):
            read = all_reads[pos].upper()
            pos += 1
            reads.append(read)
            ri = len(reads) - 1
            min_aln_score = max(
                int(opts.min_aln_score_percent * float(len(read))), opts.min_aln_score
            )
            band = max(len(read) - min_aln_score, 0)
            x_drop = band
            read_params.append((min_aln_score, band, x_drop))
            read_off = ri * RPAD
            rtasks: List[_Task] = []
            mems = self.seeder.all_smems(read)
            for hit in mems:
                aln_ref, _ = index.idx_to_ref(hit.ref_idx)

                # genome window (reference src/aligner.rs:209-227)
                seq_start = max(hit.ref_idx - (len(read) + band), aln_ref.start_idx)
                seq_end = min(
                    hit.ref_idx + hit.len + len(read) + band, aln_ref.end_idx - 1
                )
                rel = Mem(hit.ref_idx - seq_start, hit.query_idx, hit.len)
                lp, rp = self._extend_problems(
                    problems, hit.ref_idx, hit.len, seq_start, seq_end,
                    read_off, hit.query_idx, len(read), band, x_drop,
                )
                rtasks.append(
                    _Task(
                        read_i=ri,
                        kind="gx",
                        hit=rel,
                        left_pid=lp,
                        right_pid=rp,
                        ref_len=seq_end - seq_start,
                        seq_start=seq_start,
                        abs_hit=hit,
                    )
                )

                # transcriptome candidates (src/aligner.rs:230-258)
                tx_idxs = sorted(
                    set(
                        index.txome.exon_to_tx.find(
                            hit.ref_idx, hit.ref_idx + hit.len
                        ).tolist()
                    )
                )
                for tx_idx in tx_idxs:
                    tx = index.txome.txs[tx_idx]
                    tx_seed = lift_mem_to_tx(hit, tx)
                    tx_seed = extend_seed_match(tx.seq, tx_seed, read)
                    base = int(self.tx_off[tx_idx])
                    y_lo_tx = max(tx_seed.ref_idx - (len(read) + band), 0)
                    lp, rp = self._extend_problems(
                        problems, base + tx_seed.ref_idx, tx_seed.len,
                        base + y_lo_tx, base + len(tx.seq),
                        read_off, tx_seed.query_idx, len(read), band, x_drop,
                    )
                    rtasks.append(
                        _Task(
                            read_i=ri,
                            kind="tx",
                            hit=tx_seed,
                            left_pid=lp,
                            right_pid=rp,
                            ref_len=len(tx.seq),
                            abs_hit=hit,
                            tx_idx=tx_idx,
                        )
                    )
            per_read_tasks.append(rtasks)
            tasks.extend(rtasks)

        # padded read block (device-resident for the duration of the
        # chunk); rows padded to a power-of-two bucket so the jitted
        # gather sees a bounded set of shapes across chunks
        reads_pad = np.zeros((self._reads_bucket(len(reads)), RPAD), np.uint8)
        for ri, r in enumerate(reads):
            reads_pad[ri, : len(r)] = np.frombuffer(r, np.uint8)
        st.reads_host = reads_pad
        st.reads_dev = reads_pad
        st.meta_all = st.problems.meta()
        return st, pos

    def _pack_meta(self, meta: np.ndarray) -> np.ndarray:
        """Upload problem meta in the 4-col packed form (55% less h2d
        per chunk) when every field fits its packed range; kernels
        accept both forms, so oversize fields just ride unpacked."""
        from ..ops.layout import pack_meta_host

        try:
            return pack_meta_host(meta)
        except ValueError:
            return meta

    def _put_reads(self, reads_pad: np.ndarray):
        """Upload the chunk's read block nibble-packed (half the bytes
        of the ASCII block; the native pack is the bit-identical twin of
        ``ops.layout.pack_reads_nib_host``)."""
        nib = self.native.nib_pack_reads(reads_pad)
        return jax.device_put(nib, self._sharding_repl())

    def _build_chunk_native(
        self, all_reads: List[bytes], start: int
    ) -> Tuple["_ChunkState", int]:
        # take a bit more than the running reads-per-chunk estimate so the
        # problem budget, not `take`, usually cuts the chunk — without
        # uppercasing/packing far more reads than will be consumed
        est = getattr(self, "_est_chunk_reads", self.PROBLEM_BUDGET // 4)
        take = min(len(all_reads) - start, max(256, (est * 5) // 4))
        paired = getattr(self, "_paired_build", False)
        if paired and take % 2:
            # never OFFER a half pair: with an even offer and pair-
            # boundary budget cuts, consumption is always even too
            take += 1 if start + take < len(all_reads) else -1
        reads = all_reads[start : start + max(take, 0)]
        RPAD = self._RPAD
        # one native pass: uppercase + scatter into the padded block +
        # lengths (replaces ~4 us/read of Python loop + .upper())
        reads_pad, read_lens = self.native.prep_reads(
            reads, _pow2_bucket(max(len(reads), 1), 256), RPAD
        )
        t0 = time.time()
        ch, consumed, meta, tasks = self.native.build_chunk(
            reads_pad, read_lens, len(reads), self.PROBLEM_BUDGET,
            paired=paired,
        )
        if self.pipeline_depth is None and consumed >= 1024:
            # very expensive builds (genome-scale seed lookups,
            # ~3 s/chunk) lose more to poll-thread contention than
            # pipeline overlap saves on a single-core host, while
            # chromosome-scale builds (~0.2 s/chunk) overlap with the
            # device kernel.  The FIRST chunk over-measures (cold
            # caches/TLB on a freshly loaded seed table), so decide
            # from the second sample.
            per_chunk = (time.time() - t0) * self.PROBLEM_BUDGET / max(
                len(meta), 1
            )
            samples = getattr(self, "_build_samples", [])
            samples.append(per_chunk)
            self._build_samples = samples
            if len(samples) >= 2:
                self.pipeline_depth = 1 if samples[-1] > 1.0 else 2
        if consumed == take and start + consumed < len(all_reads):
            # budget not reached: grow the estimate for the next chunk
            self._est_chunk_reads = est * 2
        elif consumed < take:
            # budget-limited chunk: this is the real reads-per-chunk
            # estimate.  (A tail chunk — consumed == take == remainder —
            # must NOT shrink the estimate, or every later batch would
            # restart with tiny chunks.)
            self._est_chunk_reads = consumed
        st = _ChunkState(reads=reads[:consumed])
        st.native_ch = ch
        st.meta_all = meta
        st.tasks_arr = tasks
        st.reads_host = reads_pad
        # device copy gets the sticky row bucket (stable jit shape),
        # sized by what the chunk actually consumed
        rows = self._reads_bucket(max(consumed, 1))
        if rows <= len(reads_pad):
            upload = reads_pad[:rows]
        else:
            upload = np.zeros((rows, RPAD), np.uint8)
            upload[: len(reads_pad)] = reads_pad
        st.reads_dev = (
            self._put_reads(upload) if self.backend == "stream" else upload
        )
        return st, start + consumed

    # ------------------------------------------------------------------
    def _arbitrate_chunk(self, st: "_ChunkState") -> None:
        if st.native_ch is not None:
            scores, max_i, max_j = self._forward_results(st)
            st.selected_arr, st.pid_list = self.native.arbitrate(
                st.native_ch, scores, max_i, max_j
            )
            if st.tb_full is None:
                # two-pass path (xla backend): traceback winners now
                self._dispatch_traceback(st)
            else:
                self.stats.winners += len(st.pid_list)
                self._dispatch_stream_gather(st)
            return
        opts = self.opts
        reads = st.reads
        tasks = st.tasks
        read_params = st.read_params
        per_read_tasks = st.per_read_tasks

        scores, max_i, max_j = self._forward_results(st)

        for task in tasks:
            sL, sR = scores[task.left_pid], scores[task.right_pid]
            task.score = int(sL) + MATCH_SCORE * task.hit.len + int(sR)
            l_ye, r_ye = int(max_j[task.left_pid]), int(max_j[task.right_pid])
            l_xe, r_xe = int(max_i[task.left_pid]), int(max_i[task.right_pid])
            ystart = task.hit.ref_idx - l_ye
            yend = task.hit.ref_idx + task.hit.len + r_ye
            xstart = task.hit.query_idx - l_xe
            xend = task.hit.query_idx + task.hit.len + r_xe
            task.span = (ystart, yend, xstart, xend)

        # ---- host arbitration per read ----
        winner_pids: Dict[int, None] = {}
        selected = st.selected

        for ri, read in enumerate(reads):
            min_aln_score, band, x_drop = read_params[ri]
            rtasks = per_read_tasks[ri]
            gx_alns: List[Tuple[GenomeAlignment, _Task]] = []

            # group tasks per seed: gx task followed by its tx tasks
            i = 0
            while i < len(rtasks):
                gx_task = rtasks[i]
                assert gx_task.kind == "gx"
                i += 1
                tx_tasks = []
                while i < len(rtasks) and rtasks[i].kind == "tx" and rtasks[i].abs_hit == gx_task.abs_hit:
                    tx_tasks.append(rtasks[i])
                    i += 1

                chosen = self._arbitrate_seed(read, gx_task, tx_tasks)
                ga, task = chosen
                if not opts.intron_mode and ga.aln_type != EXONIC:
                    continue
                if ga.gx_aln.score < opts.min_aln_score or ga.gx_aln.score < min_aln_score:
                    continue
                gx_alns.append(chosen)

            if gx_alns:
                max_score = max(max(g.gx_aln.score for g, _ in gx_alns), min_aln_score)
            else:
                max_score = min_aln_score
            gx_alns = [
                (g, t)
                for g, t in gx_alns
                if g.gx_aln.score >= max_score - opts.multimap_score_range
            ]

            # overlap filter + primary selection on span-only objects
            pair_of = {id(g): t for g, t in gx_alns}
            filtered = filter_overlapping([g for g, _ in gx_alns])
            filtered.sort(key=lambda a: -a.gx_aln.score)
            if filtered:
                filtered[0].primary = True
            sel = [(g, pair_of[id(g)]) for g in filtered]
            selected.append(sel)
            for _, t in sel:
                winner_pids[t.left_pid] = None
                winner_pids[t.right_pid] = None

        # ---- device pass 2: tracebacks for winners (async dispatch) ----
        st.pid_list = list(winner_pids.keys())
        self._dispatch_traceback(st)

    def _dispatch_stream_gather(self, st: "_ChunkState") -> None:
        """Winners-only op-stream transfer: gather the selected
        problems' stream rows out of the device-resident buffer and
        start their d2h (async — synced when finalize consumes them).
        The always-transferred payload is then 8 B/problem; streams
        cross only for winners (50-67% of problems on the bench
        workloads, fewer on low-multimap data)."""
        streams, st.fwd_streams = st.fwd_streams, None
        if streams is None:
            return
        pids = np.asarray(st.pid_list, np.int64)
        if len(pids) == 0:
            return
        rows = st.inv_rows[pids]
        keep = rows >= 0
        if st.patched is not None and len(st.patched):
            keep &= ~np.isin(pids, st.patched)
        need = pids[keep]
        if len(need) == 0:
            return
        # sticky row bucket (2048 granularity): stable gather shapes
        nw = max(
            _round_up(len(need), 2048), getattr(self, "_NGATHER", 0)
        )
        self._NGATHER = nw
        widx = np.zeros(nw, np.int32)
        widx[: len(need)] = rows[keep]
        if not hasattr(BatchAligner, "_GATHER_JIT"):
            BatchAligner._GATHER_JIT = jax.jit(
                lambda s, i: jnp.take(s, i, axis=0)
            )
        st.gather_pids = need
        st.gather_raw = BatchAligner._GATHER_JIT(streams, widx)
        try:
            st.gather_raw.copy_to_host_async()
        except AttributeError:
            pass

    def _take_tb(self, st: "_ChunkState") -> np.ndarray:
        """Hand the finalize stage its pid-indexed stream rows, merging
        the winners' gathered streams (synced here) into the host
        array."""
        tb_out, st.tb_full = st.tb_full, None
        if st.gather_raw is not None:
            with self.stats.dsync("finalize"):
                g = np.asarray(st.gather_raw)[: len(st.gather_pids)]
            st.gather_raw = None
            tb_out[st.gather_pids, 4 : 4 + g.shape[1]] = g
            st.gather_pids = None
        return tb_out

    def _finalize_chunk(self, st: "_ChunkState") -> List[List[GenomeAlignment]]:
        if st.native_ch is not None and self.backend == "stream":
            # full native finalize: decode+stitch+lift in C++ straight
            # from the device stream output
            return self._finalize_chunk_native_fast(st)
        ops_by_pid = self._traceback_results(st)
        if st.native_ch is not None:
            return self._finalize_chunk_native(st, ops_by_pid)
        results: List[List[GenomeAlignment]] = []
        for ri, read in enumerate(st.reads):
            out: List[GenomeAlignment] = []
            for ga, task in st.selected[ri]:
                out.append(self._finalize(read, ga, task, ops_by_pid))
            results.append(out)
        return results

    _ALN_TYPES = (EXONIC, INTRONIC, INTERGENIC)

    @staticmethod
    def _runs_to_ops(runs) -> List:
        from .types import runs_to_ops

        return runs_to_ops(runs)

    def _finalize_chunk_native_fast(
        self, st: "_ChunkState"
    ) -> List[List[GenomeAlignment]]:
        results: List[List[GenomeAlignment]] = [[] for _ in st.reads]
        sel = st.selected_arr
        if len(sel) == 0:
            st.tb_full = None
            self.native.free_chunk(st.native_ch)
            st.native_ch = None
            return results
        # single-pass: pid-indexed stream rows captured at arbitration
        tb_out = self._take_tb(st)
        fin_data = self.native.finalize(st.native_ch, tb_out, st.meta_all)
        self._objects_from_native(st, fin_data, results)
        self.native.free_chunk(st.native_ch)
        st.native_ch = None
        return results

    def _objects_from_native(
        self, st: "_ChunkState", fin_data, results, want=None
    ) -> None:
        """Build GenomeAlignment objects from native finalize outputs
        into ``results`` (one list per chunk read).  ``want`` (a set of
        chunk-local read indices) restricts the work to those reads —
        the paired emit path only materializes objects for the few
        pairs the C++ emitter left for Python mate rescue."""
        sel = st.selected_arr
        fin_runs, fin_off, tx_runs, tx_off, tx_meta, fallback = fin_data
        refs = self.index.refs
        if want is None and len(sel):
            # C object builder (csrc/thermite_objbuild.c): same
            # instances, built via tp_alloc + slot stores; fallback
            # rows come back as None placeholders replaced below
            from . import objbuild

            rl, rn, rs = self._ref_cols()
            nfall = objbuild.build(
                sel, fin_runs, fin_off, tx_runs, tx_off, tx_meta,
                fallback, st.tasks_arr[:, 9], rn, rs, rl,
                [len(r) for r in st.reads], results,
            )
            if nfall is not None:
                if nfall:
                    for s in np.flatnonzero(fallback):
                        self.stats.stream_fallbacks += 1
                        ga = self._finalize_selected_fallback(
                            st, int(s), sel[s]
                        )
                        lst = results[int(sel[s, 0])]
                        lst[lst.index(None)] = ga
                return
        # bulk C-level conversions: one tolist() per array instead of
        # per-element int() casts in the hot loop
        sel_rows = sel.tolist()
        fin_runs = fin_runs.tolist()
        fin_off = fin_off.tolist()
        tx_runs = tx_runs.tolist()
        tx_off = tx_off.tolist()
        tx_meta = tx_meta.tolist()
        task_tx = st.tasks_arr[:, 9].tolist()
        aln_types = self._ALN_TYPES
        lazy_ops = RunOps  # writers read op_runs; expand only on access
        # per-index caches hoisted out of the hot loop (attribute and
        # len() lookups cost ~1 us/alignment at bench scale)
        rl, rn, rs = self._ref_cols()
        rlens = [len(r) for r in st.reads]
        A, GA = Alignment, GenomeAlignment
        for s, row in enumerate(sel_rows):
            (ri, ti, atype, gene, refid, score, ys, ye, xs, xe, prim) = row
            if want is not None and ri not in want:
                continue
            if fallback[s]:
                self.stats.stream_fallbacks += 1
                results[ri].append(
                    self._finalize_selected_fallback(st, s, sel[s])
                )
                continue
            xlen = rlens[ri]
            gruns = fin_runs[fin_off[s] : fin_off[s + 1]]
            gx_aln = A(
                score, ys, xs, ye, xe, rl[refid], xlen, lazy_ops(gruns),
                gruns,
            )
            tx_aln = None
            if atype == 0:
                tm = tx_meta[s]
                truns = tx_runs[tx_off[s] : tx_off[s + 1]]
                tx_aln = A(
                    score, tm[0], tm[2], tm[1], tm[3], tm[4], xlen,
                    lazy_ops(truns), truns,
                )
            results[ri].append(
                GA(
                    gx_aln, aln_types[atype], rn[refid], rs[refid],
                    bool(prim), tx_aln,
                    task_tx[ti] if atype == 0 else None,
                    gene if atype == 1 else None,
                )
            )

    def _ref_cols(self):
        """(ref lens, names, strands) parallel lists, cached."""
        c = getattr(self, "_ref_cols_c", None)
        if c is None:
            refs = self.index.refs
            c = (
                [r.len for r in refs],
                [r.name for r in refs],
                [r.strand for r in refs],
            )
            self._ref_cols_c = c
        return c

    @staticmethod
    def _task_from_row(ri: int, t) -> _Task:
        """Decode one native tasks_arr row (C++ T_* column layout)."""
        return _Task(
            read_i=ri, kind="tx" if t[1] else "gx",
            hit=Mem(int(t[2]), int(t[3]), int(t[4])),
            left_pid=int(t[5]), right_pid=int(t[6]), ref_len=int(t[7]),
            seq_start=int(t[8]), tx_idx=int(t[9]),
        )

    def _finalize_selected_fallback(self, st, s, row):
        """Host recompute for a device-flagged stream (not expected)."""
        from ..ops.swg_ref import SwgExtend

        (ri, ti, atype, gene, refid, score, ys, ye, xs, xe, prim) = (
            int(v) for v in row
        )
        task = self._task_from_row(ri, st.tasks_arr[ti])
        ops_by_pid = {}
        for pid in (task.left_pid, task.right_pid):
            m = st.meta_all[pid]
            x, y = self._problem_bytes(st, m)
            band, xd = int(m[7]), int(m[8])
            ops_by_pid[pid] = SwgExtend(band).extend(x, y, band, xd)
        ref = self.index.refs[refid]
        read = st.reads[ri]
        ga = GenomeAlignment(
            gx_aln=Alignment(
                score=score, ystart=ys, xstart=xs, yend=ye, xend=xe,
                ylen=ref.len, xlen=len(read), operations=[],
            ),
            aln_type=self._ALN_TYPES[atype],
            ref_name=ref.name,
            strand=ref.strand,
            primary=bool(prim),
            tx_idx=task.tx_idx if atype == 0 else None,
            gene_idx=gene if atype == 1 else None,
        )
        return self._finalize(read, ga, task, ops_by_pid)

    def _finalize_chunk_native(
        self, st: "_ChunkState", ops_by_pid
    ) -> List[List[GenomeAlignment]]:
        results: List[List[GenomeAlignment]] = [[] for _ in st.reads]
        refs = self.index.refs
        for row in st.selected_arr:
            (ri, ti, atype, gene, refid, score, ys, ye, xs, xe, prim) = (
                int(v) for v in row
            )
            t = st.tasks_arr[ti]
            task = self._task_from_row(ri, t)
            ref = refs[refid]
            read = st.reads[ri]
            ga = GenomeAlignment(
                gx_aln=Alignment(
                    score=score, ystart=ys, xstart=xs, yend=ye, xend=xe,
                    ylen=ref.len, xlen=len(read), operations=[],
                ),
                aln_type=self._ALN_TYPES[atype],
                ref_name=ref.name,
                strand=ref.strand,
                primary=bool(prim),
                tx_idx=int(t[9]) if atype == 0 else None,
                gene_idx=gene if atype == 1 else None,
            )
            results[ri].append(self._finalize(read, ga, task, ops_by_pid))
        self.native.free_chunk(st.native_ch)
        st.native_ch = None
        return results

    # ------------------------------------------------------------------
    def _extend_problems(
        self, problems, seed_y, seed_len, y_lo, y_hi,
        read_off, q_idx, read_len, band, x_drop,
    ):
        """Right and (reversed) left extension problems for a seed
        (reference src/aligner.rs:352-375), as gather offsets.

        ``seed_y`` is the absolute seed start in the resident reference
        text; the usable y window is [y_lo, y_hi).  ylen is clamped to
        xlen + band + 1: the band slides one row per column, so no cell
        exists beyond column xlen + band — the oracle X-drop-breaks on
        the first empty column (transcript suffixes can be kilobases;
        this keeps device columns bounded without changing any output)."""
        xlen_r = read_len - q_idx - seed_len
        yb_r = seed_y + seed_len
        ylen_r = max(min(y_hi - yb_r, xlen_r + band + 1), 0)
        rp = problems.add(
            yb_r, 1, ylen_r, read_off + q_idx + seed_len, 1, xlen_r, band, x_drop
        )
        xlen_l = q_idx
        ylen_l = max(min(seed_y - y_lo, xlen_l + band + 1), 0)
        lp = problems.add(
            seed_y - 1, -1, ylen_l, read_off + q_idx - 1, -1, xlen_l, band, x_drop
        )
        return lp, rp

    def _arbitrate_seed(self, read, gx_task, tx_tasks):
        """Genome-vs-transcriptome choice for one seed
        (reference src/aligner.rs:263-313), spans only."""
        index = self.index
        aln_ref, _ = index.idx_to_ref(gx_task.abs_hit.ref_idx)
        ref_name, strand = aln_ref.name, aln_ref.strand

        best_tx = None
        for t in tx_tasks:
            if best_tx is None or t.score > best_tx.score:
                best_tx = t
            if t.score >= len(read) * MATCH_SCORE:
                break

        if best_tx is not None and best_tx.score >= gx_task.score:
            tx = index.txome.txs[best_tx.tx_idx]
            ys, ye, xs, xe = best_tx.span
            # trailing soft clip exists iff the query isn't fully consumed
            gys, gye = lift_tx_span_to_gx(ys, ye, tx, trailing_nonref=xe < len(read))
            chr_aln = _span_to_chr(index, gys, gye, xs, xe, best_tx.score, len(read))
            return (
                GenomeAlignment(
                    gx_aln=chr_aln,
                    aln_type=EXONIC,
                    ref_name=ref_name,
                    strand=strand,
                    tx_idx=best_tx.tx_idx,
                ),
                best_tx,
            )

        ys, ye, xs, xe = gx_task.span
        gys = gx_task.seq_start + ys
        gye = gx_task.seq_start + ye
        gene_idxs = index.txome.gene_intervals.find(gys, gye)
        chr_aln = _span_to_chr(index, gys, gye, xs, xe, gx_task.score, len(read))
        if len(gene_idxs) == 0:
            return (
                GenomeAlignment(
                    gx_aln=chr_aln, aln_type=INTERGENIC, ref_name=ref_name, strand=strand
                ),
                gx_task,
            )
        return (
            GenomeAlignment(
                gx_aln=chr_aln,
                aln_type=INTRONIC,
                ref_name=ref_name,
                strand=strand,
                gene_idx=int(gene_idxs[0]),
            ),
            gx_task,
        )

    def _finalize(self, read, ga, task, ops_by_pid):
        """Attach real ops to a winner (second pass decoded runs)."""
        index = self.index
        left = ops_by_pid[task.left_pid]
        right = ops_by_pid[task.right_pid]
        stitched = stitch(left, right, task.hit, task.ref_len, len(read))

        if ga.aln_type == EXONIC:
            tx = index.txome.txs[task.tx_idx]
            lifted = lift_tx_to_gx(stitched, tx)
            chr_aln = concat_to_chr_aln(index, lifted)
            ga.tx_aln = stitched
        else:
            stitched.ystart += task.seq_start
            stitched.yend += task.seq_start
            chr_aln = concat_to_chr_aln(index, stitched)

        assert (chr_aln.ystart, chr_aln.yend, chr_aln.score) == (
            ga.gx_aln.ystart,
            ga.gx_aln.yend,
            ga.gx_aln.score,
        ), "span-only arbitration disagrees with full traceback"
        ga.gx_aln = chr_aln
        return ga

    # ------------------------------------------------------------------
    def _shapes(self, meta_all):
        """Sticky shape buckets (XMAX/YMAX/W only grow, so kernel
        recompiles are bounded across batches)."""
        xmax = int(meta_all[:, 6].max(initial=1))
        ymax = int(meta_all[:, 3].max(initial=1))
        bmax = int(meta_all[:, 7].max(initial=1))
        XMAX = max(_round_up(xmax, 32), 32, getattr(self, "_XMAX", 0))
        YMAX = max(_round_up(ymax, 32), 32, getattr(self, "_YMAX", 0))
        W = max(width_for_band(bmax), getattr(self, "_W", 0))
        self._XMAX, self._YMAX, self._W = XMAX, YMAX, W
        return XMAX, YMAX, W

    @staticmethod
    def _pad_meta(meta, N):
        """Pad to N rows; padding rows are empty problems (band 1)."""
        out = np.zeros((N, meta.shape[1]), np.int32)
        out[:, 2] = 1  # y_dir
        out[:, 5] = 1  # x_dir
        out[:, 7] = 1  # band
        out[:, 8] = 1  # x_drop
        out[: len(meta)] = meta
        return out

    def _problem_bytes(self, st, meta_row) -> Tuple[bytes, bytes]:
        """Host reconstruction of a problem's x/y windows (fallback path)."""
        from ..ops.layout import _WPAD

        yw, ys, yd, yl, xb, xd, xl = (int(v) for v in meta_row[:7])
        yb = 8 * yw + ys - _WPAD
        y = self._ref_text_host[yb + yd * np.arange(yl)].tobytes()
        x = st.reads_host.reshape(-1)[xb + xd * np.arange(xl)].tobytes()
        return x, y

    _MESH_KERN_CACHE: Dict = {}

    def _stream_kernel(self, XMAX, YMAX, W, smax):
        """The per-chunk stream step (gathers + kernel + header epilogue,
        ops/stream.py), sharded over the mesh when set.  Returns
        (hdr (N, 2), streams (N, smax/16)) so the pipeline can keep op
        streams device-resident and transfer only winners'."""
        if self.mesh is None:
            from ..ops.stream import get_stream_kernel

            return get_stream_kernel(XMAX, YMAX, W, smax)
        from ..parallel.mesh import sharded_stream_kernel

        key = ("stream", self.mesh, XMAX, YMAX, W, smax)
        if key not in self._MESH_KERN_CACHE:
            self._MESH_KERN_CACHE[key] = sharded_stream_kernel(
                self.mesh, XMAX, YMAX, W, smax
            )
        return self._MESH_KERN_CACHE[key]

    def _xla_gather_kernel(self, XMAX, YMAX, W):
        if self.mesh is None:
            from ..ops.swg_batch import get_swg_gather_kernel

            return get_swg_gather_kernel(XMAX, YMAX, W)
        from ..parallel.mesh import sharded_swg_gather_kernel

        key = ("xla", self.mesh, XMAX, YMAX, W)
        if key not in self._MESH_KERN_CACHE:
            self._MESH_KERN_CACHE[key] = sharded_swg_gather_kernel(
                self.mesh, XMAX, YMAX, W
            )
        return self._MESH_KERN_CACHE[key]

    def _narrow_meta(self, meta: np.ndarray) -> np.ndarray:
        """Adaptive-banding device copy of the problem meta: band capped
        at ``narrow_band`` and ylen re-clamped to the narrowed
        xlen + band + 1 column bound.  x_drop stays the ORIGINAL value
        (the certificate reasons about the original x_drop)."""
        out = meta.copy()
        np.minimum(out[:, 7], self.narrow_band, out=out[:, 7])
        np.minimum(out[:, 3], out[:, 6] + out[:, 7] + 1, out=out[:, 3])
        return out

    def _dispatch_forward(self, st: "_ChunkState") -> None:
        meta_all = st.meta_all
        n = len(meta_all)
        if self.backend != "stream":
            XMAX, YMAX, W = self._shapes(meta_all)
            meta = self._pad_meta(
                meta_all,
                _round_up(_pow2_bucket(max(n, 1), 64), 64 * self._nsh),
            )
            kern = self._xla_gather_kernel(XMAX, YMAX, W)
            score, mi, mj, _dirs = kern(self._ref_text_host, st.reads_host, meta)
            st.fwd_raw = (score, mi, mj)
            return
        # single-pass pipeline: the stream kernel runs on every
        # nontrivial problem up front, so arbitration gets scores AND
        # finalize gets op streams from ONE device round trip (losers'
        # walks are cheap; their streams stay on the device)
        meta_dev = self._narrow_meta(meta_all) if self.narrow_band > 0 else meta_all
        XMAX, YMAX, W = self._shapes(meta_dev)
        # trivial problems (empty query or reference flank) have a known
        # result (score 0, max cell (0,0)) — roughly half of all problems
        # on short-read workloads; keep them off-device
        st.fwd_idx = np.flatnonzero((meta_dev[:, 6] > 0) & (meta_dev[:, 3] > 0))
        # similar-length problems side by side; outputs scatter back
        # through fwd_idx — bit-identical at any order (parity suites
        # enforce)
        order = np.argsort(meta_dev[st.fwd_idx, 3], kind="stable")
        st.fwd_idx = st.fwd_idx[order]
        sub = meta_dev[st.fwd_idx]
        gran = 128 * self._nsh
        nb = _round_up(
            max(_pow2_bucket(max(len(sub), 1), gran), getattr(self, "_NFWD1", 0)),
            gran,
        )
        self._NFWD1 = nb
        meta = self._pad_meta(sub, nb)
        self.stats.dp_cells += len(meta) * YMAX * W
        orig = meta_all[st.fwd_idx]
        # full-band-equivalent cell count (the fair GCUPS numerator when
        # the narrow-band pass shrinks dp_cells)
        self.stats.dp_cells_ref += int(
            np.sum(orig[:, 3] * (2 * orig[:, 7] + 1), dtype=np.int64)
        )
        # device SMAX only bounds the NARROWED walks; ORIGINAL-band
        # cert-failure patches are host-written into a wider host-side
        # array (_forward_results), so they never size the device rows
        smax = max(
            smax_for(int((sub[:, 6] + sub[:, 3]).max(initial=0))),
            getattr(self, "_SMAX", 0),
        )
        self._SMAX = smax
        hmax = smax_for(int((orig[:, 6] + orig[:, 3]).max(initial=0)))
        self._SMAX_HOST = max(smax, hmax, getattr(self, "_SMAX_HOST", 0))
        kern = self._stream_kernel(XMAX, YMAX, W, smax)
        words, lw = self._ref_text()
        st.fwd_raw, st.fwd_streams = kern(
            words, lw, st.reads_dev, self._pack_meta(meta)
        )
        # pid -> device stream row (for the winners-only gather)
        inv = np.full(n, -1, np.int32)
        inv[st.fwd_idx] = np.arange(len(st.fwd_idx), dtype=np.int32)
        st.inv_rows = inv

    def _forward_results(self, st: "_ChunkState"):
        n = len(st.meta_all)
        if self.backend != "stream":
            score, mi, mj = st.fwd_raw
            st.fwd_raw = None
            with self.stats.dsync("arbitrate"):
                out = (
                    np.asarray(score)[:n], np.asarray(mi)[:n], np.asarray(mj)[:n]
                )
            return out
        with self.stats.dsync("arbitrate"):
            sub = np.asarray(st.fwd_raw)[: len(st.fwd_idx)]
        st.fwd_raw = None
        # only the packed (n, 2) int16-halves headers crossed; op streams
        # stay device-resident until arbitration picks winners.  The host
        # row array is sized for ORIGINAL-band walks (cert-failure
        # patches recompute at full band into these rows).
        from ..ops.layout import expand_stream_hdr

        hdr = expand_stream_hdr(sub)
        pw_dev = int(st.fwd_streams.shape[1])
        pw_host = max(getattr(self, "_SMAX_HOST", 0) // 16, pw_dev)
        full = np.zeros((n, 4 + pw_host), np.int32)
        full[st.fwd_idx, :4] = hdr
        # narrow-band certificate failures (nsteps <= -2) and flagged
        # walks (-1): recompute those problems exactly at the ORIGINAL
        # band with the C++ scalar oracle and splice the rows in —
        # downstream stages then see bit-exact full-band results
        bad = np.flatnonzero(full[:, 3] < 0)
        if len(bad):
            self.native.patch_rows(
                st.meta_all, bad, st.reads_host, self._ref_text_host, full,
            )
            self.stats.cert_patches += len(bad)
        st.patched = bad
        st.tb_full = full
        return full[:, 0], full[:, 1], full[:, 2]

    def _dispatch_traceback(self, st: "_ChunkState") -> None:
        """Two-pass xla path: traceback pass for the winners."""
        if st.pid_list is None or len(st.pid_list) == 0:
            return
        meta_sub = st.meta_all[np.asarray(st.pid_list, np.int64)]
        st.tb_meta_sub = meta_sub
        n = len(st.pid_list)
        self.stats.winners += n
        XMAX, YMAX, W = self._shapes(st.meta_all)
        meta = self._pad_meta(
            meta_sub, _round_up(_pow2_bucket(n, 64), 64 * self._nsh)
        )
        kern = self._xla_gather_kernel(XMAX, YMAX, W)
        st.tb_raw = (kern(self._ref_text_host, st.reads_host, meta), meta)

    def _traceback_results(self, st: "_ChunkState"):
        ops_by_pid: Dict[int, Alignment] = {}
        pid_list = st.pid_list
        if pid_list is None or len(pid_list) == 0:
            return ops_by_pid
        from ..ops.traceback import traceback_batch

        (score, mi, mj, dirs), meta = st.tb_raw
        st.tb_raw = None
        alns = traceback_batch(
            np.asarray(dirs), meta[:, 7], np.asarray(mi), np.asarray(mj),
            meta[:, 6], meta[:, 3], np.asarray(score),
        )
        for k, pid in enumerate(pid_list):
            ops_by_pid[pid] = alns[k]
        return ops_by_pid


def _serialize_records(
    index, recs, results, fmt_bam, strip_tags: bool = False
) -> bytes:
    """Python-writer serialization of one chunk's records (the emit
    fallback and parity referee).  ``fmt_bam``: False = SAM, True =
    BAM, 2 = PAF (unmapped reads emit nothing, matching the CLI's
    object path and reference src/aligner.rs:58-115)."""
    from ..io.bam import encode_bam_record
    from ..io.sam import aln_to_sam_record, unique_refs, unmapped_sam_record

    if fmt_bam == 2:
        from ..io.paf import paf_line

        parts: List[bytes] = []
        for (name, seq, qual), alns in zip(recs, results):
            for aln in alns:
                parts.append(
                    (paf_line(name, seq, aln, len(alns)) + "\n").encode()
                )
        return b"".join(parts)

    ref_ids = {name: i for i, (name, _) in enumerate(unique_refs(index))}
    out: List[bytes] = []
    _STRIP = {"TX", "GX", "GN", "RE"}

    def ser(rec):
        if strip_tags:
            rec.tags = [t for t in rec.tags if t[0] not in _STRIP]
        if fmt_bam:
            return encode_bam_record(rec, ref_ids)
        return (rec.to_line() + "\n").encode()

    for (name, seq, qual), alns in zip(recs, results):
        qual = qual or b""
        if not alns:
            out.append(ser(unmapped_sam_record(name, seq, qual)))
            continue
        for i, aln in enumerate(alns):
            out.append(
                ser(aln_to_sam_record(index, name, seq, qual, aln, len(alns), i + 1))
            )
    return b"".join(out)


def _span_to_chr(index, gys, gye, xs, xe, score, read_len):
    """Concatenated span -> chromosome-coordinate span-only Alignment
    (reference src/aligner.rs:429-449, spans only)."""
    aln_ref, _ = index.idx_to_ref(gys)
    if aln_ref.strand:
        ystart = gys - aln_ref.start_idx
        yend = gye - aln_ref.start_idx
    else:
        ystart = aln_ref.len - (gye - aln_ref.start_idx)
        yend = aln_ref.len - (gys - aln_ref.start_idx)
    return Alignment(
        score=score,
        ystart=ystart,
        xstart=xs,
        yend=yend,
        xend=xe,
        ylen=aln_ref.len,
        xlen=read_len,
        operations=[],
    )
