"""Embedding API mimicking the reference's Orbit/STAR-compatible
wrapper (reference src/wrapper.rs:19-141): a per-read alignment object
a host application (Cell Ranger) can clone across workers over one
shared index.

Differences from the reference dictated by the batched design:
* ``align_read`` serves the one-off/per-read path via the CPU oracle;
  ``align_reads`` serves batches via the device pipeline — the embedding
  surface production callers should use.
* Records are returned as ``SamRecord`` objects (this framework's
  record model) with the TX/GX/GN/RE tags stripped, matching the
  reference wrapper's tag removal (src/wrapper.rs:136-139).
"""

from __future__ import annotations

from typing import List, Optional

from .align.driver import AlignOpts, OracleAligner
from .constants import (
    DEFAULT_MIN_ALN_SCORE,
    DEFAULT_MIN_ALN_SCORE_PERCENT,
    DEFAULT_MIN_SEED_LEN,
    DEFAULT_MULTIMAP_SCORE_RANGE,
)
from .index.build import Index
from .io.sam import SamRecord, aln_to_sam_record, build_sam_header, unmapped_sam_record

_STRIP_TAGS = {"TX", "GX", "GN", "RE"}


class ThermiteAligner:
    """Reference src/wrapper.rs:21-124 surface."""

    def __init__(self, index_path: str):
        self.index = Index.load(index_path)
        # reference wrapper defaults (src/wrapper.rs:40-46)
        self.align_opts = AlignOpts(
            min_seed_len=DEFAULT_MIN_SEED_LEN,
            min_aln_score_percent=DEFAULT_MIN_ALN_SCORE_PERCENT,
            min_aln_score=DEFAULT_MIN_ALN_SCORE,
            multimap_score_range=DEFAULT_MULTIMAP_SCORE_RANGE,
            intron_mode=False,
        )
        self._oracle: Optional[OracleAligner] = None
        self._batch = None

    # -- alignment ------------------------------------------------------

    def align_read(self, name: bytes, read: bytes, qual: bytes) -> List[SamRecord]:
        """Align one read; always returns >= 1 record (unmapped record
        when nothing aligns), like src/wrapper.rs:64-101."""
        if self._oracle is None:
            self._oracle = OracleAligner(self.index, self.align_opts)
        alns = self._oracle.align_read(read)
        return self._records(name, read, qual, alns)

    def align_reads(
        self, names: List[bytes], reads: List[bytes], quals: List[bytes]
    ) -> List[List[SamRecord]]:
        """Batch path on the device pipeline (record objects)."""
        if self._batch is None:
            from .align.batch import BatchAligner

            self._batch = BatchAligner(self.index, self.align_opts)
        out = []
        for name, read, qual, alns in zip(
            names, reads, quals, self._batch.align_batch(reads)
        ):
            out.append(self._records(name, read, qual, alns))
        return out

    def align_reads_records(
        self,
        names: List[bytes],
        reads: List[bytes],
        quals: List[bytes],
        fmt_bam: bool = False,
    ) -> bytes:
        """Production batch surface: serialized record bytes straight
        from the C++ emitter (SAM text lines, or BAM record blobs when
        ``fmt_bam``), TX/GX/GN/RE stripped like the reference wrapper
        (src/wrapper.rs:136-139), in input order with >= 1 record per
        read.  Byte-identical to serializing ``align_reads`` output
        (tests/test_wrapper.py); skips the object-materialization cost
        the CLI emit path already avoids."""
        if self._batch is None:
            from .align.batch import BatchAligner

            self._batch = BatchAligner(self.index, self.align_opts)
        recs = [
            (n, r, q or b"") for n, r, q in zip(names, reads, quals)
        ]
        return self._batch.align_batch_emit(recs, fmt_bam, strip_tags=True)

    def align_read_pairs_records(
        self,
        names: List[bytes],
        reads1: List[bytes],
        quals1: List[bytes],
        reads2: List[bytes],
        quals2: List[bytes],
        fmt_bam: bool = False,
        max_insert: int = 1000,
        mate_rescue: bool = True,
    ) -> bytes:
        """Production paired batch surface: serialized record bytes
        from the C++ paired emitter (``BatchAligner.align_paired_emit``)
        — FR pairing + mate fields (flags 0x1/0x2/..., RNEXT/PNEXT/
        TLEN), mate rescue, TX/GX/GN/RE stripped like the single-end
        wrapper surface.  Input-pair order; >= 2 records per pair.
        Byte-identical to serializing ``align_read_pair`` output with
        the Python writers (tests/test_wrapper.py)."""
        if self._batch is None:
            from .align.batch import BatchAligner

            self._batch = BatchAligner(self.index, self.align_opts)
        pair_recs = [
            ((n, r1, q1 or b""), (n, r2, q2 or b""))
            for n, r1, q1, r2, q2 in zip(
                names, reads1, quals1, reads2, quals2
            )
        ]
        return self._batch.align_paired_emit(
            pair_recs, fmt_bam, max_insert=max_insert,
            mate_rescue=mate_rescue, strip_tags=True,
        )

    def align_read_pair(
        self,
        name: bytes,
        read1: bytes,
        qual1: bytes,
        read2: bytes,
        qual2: bytes,
        max_insert: int = 1000,
        mate_rescue: bool = True,
    ) -> List[SamRecord]:
        """Paired-end embedding surface (beyond reference parity — the
        reference wrapper is single-end): both mates through the
        aligner, FR pairing + mate fields via ``align.paired``
        (incl. mate rescue unless ``mate_rescue=False``), TX/GX/GN/RE
        stripped as usual.  Always >= 2 records."""
        from .align.paired import pair_records

        if self._oracle is None:
            self._oracle = OracleAligner(self.index, self.align_opts)

        class _R:
            __slots__ = ("id", "seq", "qual")

            def __init__(self, rid, seq, qual):
                self.id, self.seq, self.qual = rid, seq, qual

        recs = pair_records(
            self.index,
            _R(name, read1, qual1),
            _R(name, read2, qual2),
            self._oracle.align_read(read1),
            self._oracle.align_read(read2),
            max_insert,
            rescue_opts=self.align_opts if mate_rescue else None,
        )
        for rec in recs:
            rec.tags = [t for t in rec.tags if t[0] not in _STRIP_TAGS]
        return recs

    def _records(self, name, read, qual, alns) -> List[SamRecord]:
        if not alns:
            return [unmapped_sam_record(name, read, qual)]
        recs = []
        for i, aln in enumerate(alns):
            rec = aln_to_sam_record(
                self.index, name, read, qual, aln, len(alns), i + 1
            )
            rec.tags = [t for t in rec.tags if t[0] not in _STRIP_TAGS]
            recs.append(rec)
        return recs

    # -- accessors (src/wrapper.rs:104-123) ------------------------------

    @staticmethod
    def est_mem(index_path: str) -> int:
        import os

        return os.path.getsize(index_path)

    @property
    def opts(self) -> AlignOpts:
        return self.align_opts

    def set_opts(self, opts: AlignOpts) -> None:
        self.align_opts = opts
        self._oracle = None
        self._batch = None

    def header(self) -> str:
        return build_sam_header(self.index)
