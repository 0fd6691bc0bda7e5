"""Direct ports of the reference's aligner.rs unit tests.

The reference has exactly two handwritten driver-level cases
(src/aligner.rs:472-601 ``test_filter_overlapping`` and
src/aligner.rs:603-639 ``test_extend_left_right``); the fixture E2E
suites exercise both functions indirectly, but these ports pin the
exact expected structures so a behaviour drift fails loudly at the
unit level, like upstream CI would.
"""

from thermite.align.driver import filter_overlapping
from thermite.align.extend import extend_left_right
from thermite.align.types import (
    Alignment,
    GenomeAlignment,
    INTERGENIC,
    Mem,
    xclip,
)
from thermite.ops.swg_ref import SwgExtend


def _ga(score, ystart, yend, strand):
    return GenomeAlignment(
        gx_aln=Alignment(
            score=score, ystart=ystart, xstart=0, yend=yend, xend=0,
            ylen=0, xlen=0, operations=[],
        ),
        aln_type=INTERGENIC,
        ref_name="a",
        strand=strand,
        primary=False,
    )


def test_filter_overlapping():
    # reference src/aligner.rs:472-601: four intergenic alignments on
    # ref "a"; the (3,6) score-0 '+' aln is absorbed by the overlapping
    # (5,10) score-1 '+' aln; the '-' strand aln survives independently
    gx_alns = [
        _ga(0, 3, 6, True),
        _ga(1, 5, 10, True),
        _ga(0, 10, 15, True),
        _ga(0, 5, 15, False),
    ]
    want = [
        _ga(0, 5, 15, False),
        _ga(1, 5, 10, True),
        _ga(0, 10, 15, True),
    ]
    assert filter_overlapping(gx_alns) == want


def test_extend_left_right():
    # reference src/aligner.rs:603-639 (SwgExtend::new(4), unit scores;
    # extend called at band_width = 1, x_drop = 1)
    swg = SwgExtend(4)
    x = b"GGGGCCTTGAGTAA"
    y = b"AAAAAAACCTTGGGTTTTTTTT"
    hit = Mem(ref_idx=9, query_idx=6, len=3)
    want = Alignment(
        score=6,
        ystart=7,
        xstart=4,
        yend=15,
        xend=12,
        ylen=22,
        xlen=14,
        operations=[
            xclip(4),
            "M", "M", "M", "M", "M",
            "S",
            "M", "M",
            xclip(2),
        ],
    )
    got = extend_left_right(y, hit, x, swg, 1, 1)
    assert got == want
