"""The C object builder (csrc/thermite_objbuild.c) must produce the
exact same GenomeAlignment/Alignment/RunOps tree as the pure-Python
loop in ``BatchAligner._objects_from_native`` — same classes, same
field values, same op expansion."""

import numpy as np
import pytest

from thermite.align import objbuild
from thermite.align.types import (
    EXONIC,
    INTERGENIC,
    INTRONIC,
    Alignment,
    GenomeAlignment,
    RunOps,
    runs_to_ops,
)


def _run(op, ln):
    return (op << 32) | ln


@pytest.fixture(scope="module")
def built():
    if objbuild._try_init() is None:
        pytest.skip("native object builder unavailable")
    # rows: ri, ti, atype, gene, refid, score, ys, ye, xs, xe, prim
    sel = np.array(
        [
            [0, 0, 0, -1, 0, 80, 100, 190, 0, 90, 1],   # exonic w/ tx
            [0, 1, 2, -1, 1, 60, 5, 95, 0, 90, 0],      # intergenic
            [2, 2, 1, 7, 0, 55, 11, 99, 2, 90, 1],      # intronic w/ gene
        ],
        np.int64,
    )
    fin_runs = np.array(
        [_run(0, 45), _run(1, 1), _run(0, 44),  # row 0
         _run(0, 90),                            # row 1
         _run(4, 2), _run(0, 88)],               # row 2
        np.int64,
    )
    fin_off = np.array([0, 3, 4, 6], np.int64)
    tx_runs = np.array([_run(0, 90)], np.int64)
    tx_off = np.array([0, 1, 1, 1], np.int64)
    tx_meta = np.array(
        [[4, 94, 0, 90, 1200], [0] * 5, [0] * 5], np.int64
    )
    fallback = np.zeros(3, np.uint8)
    task_tx = np.array([3, -1, -1], np.int64)
    ref_names = ["chrA", "chrB"]
    ref_strands = [True, False]
    ref_lens = [16500, 4200]
    read_lens = [90, 91, 92]
    results = [[], [], []]
    nfall = objbuild.build(
        sel, fin_runs, fin_off, tx_runs, tx_off, tx_meta, fallback,
        task_tx, ref_names, ref_strands, ref_lens, read_lens, results,
    )
    assert nfall == 0
    return results


def test_structure(built):
    assert [len(r) for r in built] == [2, 0, 1]
    for lst in built:
        for ga in lst:
            assert type(ga) is GenomeAlignment
            assert type(ga.gx_aln) is Alignment
            assert type(ga.gx_aln.operations) is RunOps


def test_exonic_row(built):
    ga = built[0][0]
    assert ga.aln_type is EXONIC
    assert ga.ref_name == "chrA"
    assert ga.strand is True
    assert ga.primary is True
    assert ga.tx_idx == 3
    assert ga.gene_idx is None
    a = ga.gx_aln
    assert (a.score, a.ystart, a.xstart, a.yend, a.xend) == (80, 100, 0, 190, 90)
    assert (a.ylen, a.xlen) == (16500, 90)
    assert a.op_runs == [_run(0, 45), _run(1, 1), _run(0, 44)]
    # the lazy view and the runs share one list object
    assert a.operations._runs is a.op_runs
    assert list(a.operations) == runs_to_ops(a.op_runs)
    t = ga.tx_aln
    assert type(t) is Alignment
    assert (t.score, t.ystart, t.xstart, t.yend, t.xend) == (80, 4, 0, 94, 90)
    assert (t.ylen, t.xlen) == (1200, 90)
    assert t.op_runs == [_run(0, 90)]


def test_intergenic_and_intronic(built):
    gb = built[0][1]
    assert gb.aln_type is INTERGENIC
    assert gb.ref_name == "chrB"
    assert gb.strand is False
    assert gb.primary is False
    assert gb.tx_aln is None and gb.tx_idx is None and gb.gene_idx is None
    gc_ = built[2][0]
    assert gc_.aln_type is INTRONIC
    assert gc_.gene_idx == 7
    assert gc_.tx_aln is None and gc_.tx_idx is None
    assert gc_.gx_aln.operations == [("SC", 2)] + ["M"] * 88


def test_fallback_placeholders():
    if objbuild._try_init() is None:
        pytest.skip("native object builder unavailable")
    sel = np.array(
        [
            [0, 0, 2, -1, 0, 60, 5, 95, 0, 90, 1],
            [0, 0, 2, -1, 0, 59, 6, 96, 0, 90, 0],
        ],
        np.int64,
    )
    fin_runs = np.array([_run(0, 90)], np.int64)
    fin_off = np.array([0, 1, 1], np.int64)
    z = np.zeros(0, np.int64)
    tx_off = np.array([0, 0, 0], np.int64)
    tx_meta = np.zeros((2, 5), np.int64)
    fallback = np.array([0, 1], np.uint8)
    results = [[]]
    nfall = objbuild.build(
        sel, fin_runs, fin_off, z, tx_off, tx_meta, fallback,
        np.array([-1], np.int64), ["c"], [True], [100], [90], results,
    )
    assert nfall == 1
    assert len(results[0]) == 2
    assert results[0][1] is None
    assert results[0][0].gx_aln.score == 60


def test_bad_rows_leave_results_untouched():
    """Invalid sel rows (bad refid / ri / atype / ti / offset ranges)
    must be rejected in the C pre-pass with results completely
    untouched — the caller re-runs the Python loop on the same lists,
    so any partial append would duplicate alignments."""
    if objbuild._try_init() is None:
        pytest.skip("native object builder unavailable")
    fin_runs = np.array([_run(0, 90), _run(0, 90)], np.int64)
    tx_off = np.array([0, 0, 0], np.int64)
    tx_meta = np.zeros((2, 5), np.int64)
    fallback = np.zeros(2, np.uint8)
    z = np.zeros(0, np.int64)

    def attempt(sel, fin_off, task_tx):
        results = [[], []]
        rc = objbuild.build(
            np.array(sel, np.int64), fin_runs, np.array(fin_off, np.int64),
            z, tx_off, tx_meta, fallback, np.array(task_tx, np.int64),
            ["c"], [True], [100], [90, 90], results,
        )
        assert rc is None
        assert results == [[], []]

    good = [0, 0, 2, -1, 0, 60, 5, 95, 0, 90, 1]
    bad_ref = [1, 0, 2, -1, 9, 60, 5, 95, 0, 90, 0]
    bad_ri = [5, 0, 2, -1, 0, 60, 5, 95, 0, 90, 0]
    bad_atype = [1, 0, 3, -1, 0, 60, 5, 95, 0, 90, 0]
    bad_ti = [1, 99, 0, -1, 0, 60, 5, 95, 0, 90, 0]  # exonic, ti OOB
    for bad in (bad_ref, bad_ri, bad_atype, bad_ti):
        # the bad row comes SECOND: a non-prevalidating builder would
        # have appended the good row before noticing
        attempt([good, bad], [0, 1, 2], [-1])
    # fin_off range past the runs array
    attempt([good, good], [0, 1, 5], [-1])


def test_equal_to_python_dataclasses(built):
    ga = built[0][0]
    manual = Alignment(
        score=80, ystart=100, xstart=0, yend=190, xend=90,
        ylen=16500, xlen=90,
        operations=runs_to_ops([_run(0, 45), _run(1, 1), _run(0, 44)]),
    )
    assert ga.gx_aln == manual  # dataclass eq via expanded RunOps


def test_pipeline_ab_vs_python_loop(tmp_path, monkeypatch):
    """Interpret-mode pipeline A/B: the same chunk finalized through
    the C builder and through the pure-Python loop must produce equal
    object trees (the Python loop is forced by making the builder
    report unavailable)."""
    if objbuild._try_init() is None:
        pytest.skip("native object builder unavailable")
    from fixtures import write_fixture

    from thermite.align.batch import BatchAligner
    from thermite.align.driver import AlignOpts
    from thermite.index.build import Index

    ref, gtf, _ = write_fixture(tmp_path)
    idx = Index.create_from_files(ref, gtf)
    opts = AlignOpts(
        min_seed_len=3, min_aln_score_percent=0.0, min_aln_score=0,
        intron_mode=True,
    )
    reads = [
        b"ATTACAG", b"ACTCTCAG", b"ATTGACTTAAC", b"ATTTTAAC",
        b"ATTGTCTTAAC", b"GTTAAGTCAA", b"ATTACA", b"TGGCTAGCTA",
    ]
    b1 = BatchAligner(idx, opts, backend="stream")
    if b1.native is None:
        pytest.skip("native engine unavailable")
    out_c = b1.align_batch(reads)
    b2 = BatchAligner(idx, opts, backend="stream")
    monkeypatch.setattr(objbuild, "build", lambda *a, **k: None)
    out_py = b2.align_batch(reads)
    assert sum(len(o) for o in out_c) > 0
    for a, b in zip(out_c, out_py):
        assert len(a) == len(b)
        for ga_c, ga_py in zip(a, b):
            assert ga_c.aln_type == ga_py.aln_type
            assert ga_c.ref_name == ga_py.ref_name
            assert ga_c.strand == ga_py.strand
            assert ga_c.primary == ga_py.primary
            assert ga_c.tx_idx == ga_py.tx_idx
            assert ga_c.gene_idx == ga_py.gene_idx
            assert ga_c.gx_aln == ga_py.gx_aln
            assert ga_c.tx_aln == ga_py.tx_aln
