"""Transcriptome lifting tests — the reference's expected values
(reference src/txome.rs:168-341) carried over verbatim."""

from thermite.align.types import Alignment, Mem, yclip
from thermite.index.txome import Exon, IntervalTable, Tx, lift_mem_to_tx, lift_tx_to_gx

M, S, I, D = "M", "S", "I", "D"


def _tx(exons):
    return Tx(id="", chrom="", strand=True, exons=exons, seq=b"", gene_idx=0)


TWO_EXON_TX = _tx([Exon(3, 6, 0), Exon(10, 13, 0)])


def test_lift_mem_to_tx():
    assert lift_mem_to_tx(Mem(4, 3, 2), TWO_EXON_TX) == Mem(1, 3, 2)
    # MEM hangs off the left edge of exon 2: clipped, query shifted.
    assert lift_mem_to_tx(Mem(9, 3, 3), TWO_EXON_TX) == Mem(3, 4, 2)
    # MEM hangs off the right edge of exon 2: clipped.
    assert lift_mem_to_tx(Mem(12, 3, 3), TWO_EXON_TX) == Mem(5, 3, 1)


def test_lift_tx_to_gx():
    aln = Alignment(0, 1, 0, 4, 3, 15, 3, [M, S, I, D])
    out = lift_tx_to_gx(aln, TWO_EXON_TX)
    assert out == Alignment(0, 4, 0, 11, 3, 15, 3, [M, S, yclip(4), I, D])


def test_lift_tx_to_gx_insert_end():
    tx = _tx([Exon(3, 6, 0)])
    aln = Alignment(0, 1, 0, 3, 2, 15, 2, [M, S, I])
    out = lift_tx_to_gx(aln, tx)
    assert out == Alignment(0, 4, 0, 6, 2, 15, 2, [M, S, I])


def test_interval_table():
    t = IntervalTable([0, 5, 10, 2], [4, 8, 20, 30], [0, 1, 2, 3])
    assert sorted(t.find(6, 7).tolist()) == [1, 3]
    assert sorted(t.find(0, 100).tolist()) == [0, 1, 2, 3]
    assert sorted(t.find(9, 10).tolist()) == [3]
    assert t.find(100, 200).tolist() == []
    assert t.find(4, 5).tolist() == [3]  # [0,4) is half-open
    empty = IntervalTable([], [], [])
    assert empty.find(0, 10).tolist() == []
