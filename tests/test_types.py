"""Unit tests for the lazy RunOps view (align/types.py).

The batch pipeline attaches per-cell operations as a RunOps lazy view
over the RLE op_runs; every sequence/equality behavior a consumer
relies on (writers, parity comparisons, driver op reversal) must match
the eagerly expanded list exactly.
"""

from thermite.align.types import Alignment, RunOps, runs_to_ops, xclip, yclip


def _r(op, ln):
    return (op << 32) | ln


RUNS = [_r(4, 5), _r(0, 40), _r(1, 1), _r(0, 44), _r(5, 120), _r(2, 2), _r(3, 1)]


def test_expansion_matches_eager():
    lazy = RunOps(RUNS)
    eager = runs_to_ops(RUNS)
    assert list(lazy) == eager
    assert len(lazy) == len(eager)
    assert lazy[0] == xclip(5)
    assert lazy[1 + 40 + 1 + 44] == yclip(120)  # clips are single elements
    assert lazy[-1] == "I"


def test_equality_both_directions():
    lazy = RunOps(RUNS)
    eager = runs_to_ops(RUNS)
    assert lazy == eager
    assert eager == lazy  # reflected __eq__ through list NotImplemented
    assert lazy == RunOps(RUNS)
    assert lazy != runs_to_ops(RUNS[:-1])
    assert not (lazy != eager)


def test_concat_and_reversal():
    lazy = RunOps(RUNS)
    eager = runs_to_ops(RUNS)
    assert lazy + ["M"] == eager + ["M"]
    assert ["M"] + lazy == ["M"] + eager
    assert list(reversed(list(lazy))) == list(reversed(eager))


def test_alignment_equality_with_lazy_ops():
    kw = dict(score=10, ystart=0, xstart=0, yend=9, xend=9, ylen=100, xlen=9)
    a = Alignment(operations=RunOps(RUNS), op_runs=RUNS, **kw)
    b = Alignment(operations=runs_to_ops(RUNS), **kw)
    assert a == b and b == a
    # copy() materializes a plain list snapshot
    c = a.copy()
    assert isinstance(c.operations, list)
    assert c.operations == runs_to_ops(RUNS)
