"""Oracle SWG kernel tests.

The four cases are the reference kernel's unit cases with their exact
expected alignments (reference src/swg.rs:250-317); they transfer
verbatim because scoring is identical unit scoring.
"""

from thermite.align.types import Alignment, xclip
from thermite.ops.swg_ref import SwgExtend

M, S, I, D = "M", "S", "I", "D"


def test_perfect_match():
    swg = SwgExtend(4)
    aln = swg.extend(b"AAAAAAAA", b"AAAAAAAA", 1, 1)
    assert aln == Alignment(8, 0, 0, 8, 8, 8, 8, [M] * 8)


def test_suffix_clip():
    swg = SwgExtend(4)
    aln = swg.extend(b"AAAAATTT", b"AAAAAAAA", 1, 1)
    assert aln == Alignment(5, 0, 0, 5, 5, 8, 8, [M] * 5 + [xclip(3)])


def test_substitution():
    swg = SwgExtend(4)
    aln = swg.extend(b"AAATAAAA", b"AAAAAAAA", 1, 1)
    assert aln == Alignment(6, 0, 0, 8, 8, 8, 8, [M, M, M, S, M, M, M, M])


def test_double_deletion():
    swg = SwgExtend(4)
    aln = swg.extend(b"AAATTTT", b"AAACCTTTT", 2, 3)
    assert aln == Alignment(4, 0, 0, 9, 7, 9, 7, [M, M, M, D, D, M, M, M, M])


def test_empty_inputs():
    swg = SwgExtend(4)
    aln = swg.extend(b"", b"ACGT", 2, 3)
    assert aln == Alignment(0, 0, 0, 0, 0, 4, 0, [])
    aln = swg.extend(b"ACGT", b"", 2, 3)
    assert aln == Alignment(0, 0, 0, 0, 0, 0, 4, [xclip(4)])


def test_reuse_across_calls():
    # One SwgExtend instance is reused across seeds in the driver; state
    # from a previous call must not leak into results.
    swg = SwgExtend(4)
    swg.extend(b"AAATTTT", b"AAACCTTTT", 2, 3)
    aln = swg.extend(b"AAAAAAAA", b"AAAAAAAA", 1, 1)
    assert aln == Alignment(8, 0, 0, 8, 8, 8, 8, [M] * 8)
