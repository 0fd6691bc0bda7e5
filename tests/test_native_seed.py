"""Native (C++) seeding engine must be output-identical to the numpy
engine (and hence to the brute-force SMEM definition)."""

import numpy as np
import pytest

from thermite.seed import native
from thermite.seed.smem import SmemEngine

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library unavailable"
)


def _arr(seq: bytes) -> np.ndarray:
    return np.frombuffer(seq, dtype=np.uint8)


def test_matches_numpy_random():
    rng = np.random.default_rng(11)
    alpha = b"ACGTN"
    for trial in range(40):
        n = int(rng.integers(60, 400))
        text = bytes(alpha[i] for i in rng.integers(0, 5, n)) + b"$"
        L = int(rng.integers(10, 80))
        if rng.random() < 0.6:
            p = int(rng.integers(0, n - min(L, n - 1)))
            read = bytearray(text[p : p + L].replace(b"$", b"A"))
            for _ in range(int(rng.integers(0, 4))):
                read[int(rng.integers(0, len(read)))] = alpha[int(rng.integers(0, 4))]
            read = bytes(read)
        else:
            read = bytes(alpha[i] for i in rng.integers(0, 4, L))
        for k in (3, 7, 13, 20):
            got = native.NativeSmemEngine(_arr(text), k).all_smems(read)
            want = SmemEngine(_arr(text), k).all_smems(read)
            assert got == want, f"trial={trial} k={k} read={read!r}"


def test_matches_numpy_chrm(tmp_path):
    from fixtures import small_genome_index
    from thermite.io.fastx import revcomp

    idx = small_genome_index(tmp_path)
    nat = native.NativeSmemEngine(idx.seq_arr, 20)
    ref = SmemEngine(idx.seq_arr, 20)
    rng = np.random.default_rng(5)
    chrM = idx.seq[idx.refs[0].start_idx : idx.refs[0].end_idx - 1]
    for i in range(40):
        p = int(rng.integers(0, len(chrM) - 91))
        r = bytearray(chrM[p : p + 90])
        for _ in range(int(rng.integers(0, 4))):
            r[int(rng.integers(0, 90))] = b"ACGT"[int(rng.integers(0, 4))]
        r = bytes(r)
        if rng.random() < 0.5:
            r = revcomp(r)
        assert nat.all_smems(r) == ref.all_smems(r)


def test_adaptive_probe_skip_identity():
    """The adaptive probe skip (thermite_smems: jump to E-k+1 after
    each probe) must be output-identical to the probe-everything
    referee (the numpy engine) on the structures that stress its
    proof: tandem repeats (many same-diagonal occurrences), dispersed
    repeats (envelope suppression of shorter intervals), overlapping
    SMEMs from mutations, and N bytes (which force the non-skip path
    per read)."""
    rng = np.random.default_rng(23)
    alpha = b"ACGT"
    unit = bytes(alpha[i] for i in rng.integers(0, 4, 37))
    seg = bytes(alpha[i] for i in rng.integers(0, 4, 250))
    uniq = bytes(alpha[i] for i in rng.integers(0, 4, 4000))
    text = unit * 30 + uniq[:2000] + seg * 4 + b"N" * 30 + uniq[2000:] + b"$"
    nat = native.NativeSmemEngine(_arr(text), 20)
    ref = SmemEngine(_arr(text), 20)
    for i in range(300):
        L = int(rng.integers(20, 140))
        p = int(rng.integers(0, len(text) - L - 1))
        r = bytearray(text[p : p + L].replace(b"$", b"A"))
        for _ in range(int(rng.integers(0, 5))):
            r[int(rng.integers(0, L))] = b"ACGTN"[int(rng.integers(0, 5))]
        r = bytes(r)
        assert nat.all_smems(r) == ref.all_smems(r), f"i={i} read={r!r}"


def test_stride_hint_enables_skip_identically():
    """Classic posting arrays adopted with a stride hint (the artifact
    meta['seed_stride'] path) must produce identical output to both
    the un-hinted adoption (skip off) and the numpy referee."""
    rng = np.random.default_rng(31)
    alpha = b"ACGT"
    text = bytes(alpha[i] for i in rng.integers(0, 4, 30000)) + b"$"
    arr = _arr(text)
    built = native.NativeSmemEngine(arr, 20)
    table = built.export_table()
    hinted = native.NativeSmemEngine(arr, 20, table=table, stride_known=1)
    plain = native.NativeSmemEngine(arr, 20, table=table)
    ref = SmemEngine(arr, 20)
    for i in range(120):
        L = int(rng.integers(20, 120))
        p = int(rng.integers(0, len(text) - L - 1))
        r = bytearray(text[p : p + L].replace(b"$", b"A"))
        for _ in range(int(rng.integers(0, 4))):
            r[int(rng.integers(0, L))] = alpha[int(rng.integers(0, 4))]
        r = bytes(r)
        want = ref.all_smems(r)
        assert hinted.all_smems(r) == want
        assert plain.all_smems(r) == want


def test_interleaved_chunk_seed_identity(tmp_path):
    """Sequential chunk builds pre-seed through the W-way interleaved
    engine; the threaded path seeds per read.  Outputs must be
    bit-identical, including dirty reads (N bytes -> per-read referee
    fallback) and repeat-heavy reads."""
    import os

    from fixtures import small_genome_index
    from thermite.align.batch import BatchAligner
    from thermite.align.driver import AlignOpts

    idx = small_genome_index(tmp_path)
    opts = AlignOpts(
        min_seed_len=20, min_aln_score_percent=0.0, min_aln_score=30,
        intron_mode=True,
    )
    aligner = BatchAligner(idx, opts, backend="xla", use_native=True)
    rng = np.random.default_rng(3)
    chrM = idx.seq[idx.refs[0].start_idx : idx.refs[0].end_idx - 1]
    reads = []
    for i in range(400):
        p = int(rng.integers(0, len(chrM) - 91))
        r = bytearray(chrM[p : p + 90])
        for _ in range(int(rng.integers(0, 4))):
            r[int(rng.integers(0, 90))] = b"ACGTN"[int(rng.integers(0, 5))]
        reads.append(bytes(r))
    reads.append(b"N" * 90)          # fully dirty
    reads.append(chrM[100:115])      # short (below min_seed_len)
    rpad = 96
    reads_pad = np.zeros((len(reads), rpad), np.uint8)
    lens = np.zeros(len(reads), np.int64)
    for i, r in enumerate(reads):
        reads_pad[i, : len(r)] = np.frombuffer(r.upper(), np.uint8)
        lens[i] = len(r)

    outs = {}
    old = os.environ.get("THERMITE_THREADS")
    try:
        for n in ("1", "4"):  # 1 = interleaved pre-pass, 4 = per-read
            os.environ["THERMITE_THREADS"] = n
            ch, consumed, meta, tasks = aligner.native.build_chunk(
                reads_pad, lens, len(reads), 10**9
            )
            aligner.native.free_chunk(ch)
            outs[n] = (consumed, meta, tasks)
    finally:
        if old is None:
            os.environ.pop("THERMITE_THREADS", None)
        else:
            os.environ["THERMITE_THREADS"] = old
    assert outs["1"][0] == outs["4"][0] == len(reads)
    assert outs["1"][1].shape == outs["4"][1].shape
    assert (outs["1"][1] == outs["4"][1]).all()
    assert (outs["1"][2] == outs["4"][2]).all()


def test_wide_key_radix_buckets():
    """k=20 base-5 keys exceed 32 bits; two distinct keys equal modulo
    2^32 interleaved between repeats of one key must not split its
    posting bucket (regression: the radix sort originally covered only
    32 bits, so equal-low-word keys stayed interleaved and the second
    occurrence landed in a shadowed duplicate bucket)."""
    import numpy as np

    from thermite.seed.native import NativeSmemEngine
    from thermite.seed.smem import SmemEngine

    def kmer_of(key):  # base-5 -> ACGTN string of length 20
        s = []
        for _ in range(20):
            s.append("ACGTN"[key % 5])
            key //= 5
        return "".join(reversed(s))

    key1 = (3 * 5**19) + 12345  # > 2^32
    key2 = key1 + (1 << 32)
    assert key2 < 5**20
    a, b = kmer_of(key1), kmer_of(key2)
    text = (a + "C" * 25 + b + "C" * 25 + a).encode()
    arr = np.frombuffer(text, np.uint8)
    native = NativeSmemEngine(arr, 20)
    ref = SmemEngine(arr, 20)
    read = a.encode()
    got = native.all_smems(read)
    want = ref.all_smems(read)
    assert got == want
    # the repeated 20-mer must be found at BOTH text positions
    assert len({m.ref_idx for m in got}) >= 2


def test_persisted_seed_table_roundtrip(tmp_path):
    """The artifact carries the posting table; a seeder restored from it
    is output-identical to a fresh build (and a k mismatch rebuilds)."""
    import numpy as np

    from thermite.index.build import Index
    from thermite.seed.native import make_seeder

    from fixtures import write_fixture

    ref, gtf, _ = write_fixture(tmp_path)
    idx = Index.create_from_files(ref, gtf)
    p = str(tmp_path / "t.npz")
    idx.save(p)
    idx2 = Index.load(p)
    assert idx2.seed_table is not None
    assert idx2.seed_table[0] == 20  # default anchor k
    # the artifact's narrow positions are adopted as-is: widening
    # first-touches ~0.7 GB of fresh pages at chromosome scale
    assert idx2.seed_table[3].dtype == np.int32

    # table-restored seeder == fresh seeder at the persisted k
    fresh = make_seeder(idx.seq_arr, 20)
    restored = make_seeder(idx2.seq_arr, 20, table=idx2.seed_table)
    read = idx.seq[2:60]
    assert restored.all_smems(read) == fresh.all_smems(read)

    # k mismatch: the persisted table is ignored, not misused
    k3_fresh = make_seeder(idx.seq_arr, 3)
    k3_restored = make_seeder(idx2.seq_arr, 3, table=idx2.seed_table)
    read = idx.seq[2:20]
    got = k3_restored.all_smems(read)
    assert got == k3_fresh.all_smems(read) and len(got) > 0


def test_packed_build_matches_pair_build(monkeypatch):
    """The packed-u64 table build (csrc build_stride_packed) must be
    array-identical to the (key, pos) pair fallback it replaced —
    same uniq keys, offsets, and position order — across k, stride,
    and N-containing texts."""
    import numpy as np

    from thermite.seed.native import NativeSmemEngine

    rng = np.random.default_rng(7)
    alpha = np.frombuffer(b"ACGTN", np.uint8)
    for trial in range(12):
        n = int(rng.integers(50, 5000))
        # mostly ACGT with occasional N runs
        arr = rng.choice(alpha[:4], n)
        for _ in range(int(rng.integers(0, 4))):
            p = int(rng.integers(0, n))
            arr[p : p + int(rng.integers(1, 8))] = alpha[4]
        for k in (3, 11, 20):
            for stride in (1, 4):
                monkeypatch.delenv("THERMITE_TABLE_PAIR", raising=False)
                packed = NativeSmemEngine(arr, k, stride=stride).export_table()
                monkeypatch.setenv("THERMITE_TABLE_PAIR", "1")
                pair = NativeSmemEngine(arr, k, stride=stride).export_table()
                assert packed[0] == pair[0]
                for a, b in zip(packed[1:], pair[1:]):
                    assert (a == b).all(), (trial, k, stride)


def test_packed_mode_search_and_roundtrip(monkeypatch, tmp_path):
    """Packed mode (kv IS the table — the genome-scale representation,
    forced tiny here via THERMITE_PACKED_MIN): search results must be
    identical to the classic engine and the numpy oracle across k and
    stride; export must round-trip through new_from_kv, the numpy
    unpack fallback, and the Index .npz artifact."""
    import numpy as np

    from thermite.seed.native import (
        NativeSmemEngine,
        PackedSeedTable,
        _unpack_packed_table,
    )
    from thermite.seed.smem import SmemEngine

    rng = np.random.default_rng(29)
    alpha = np.frombuffer(b"ACGTN", np.uint8)
    arr = rng.choice(alpha[:4], 20000)
    for _ in range(3):  # N runs
        p = int(rng.integers(0, len(arr)))
        arr[p : p + int(rng.integers(1, 6))] = alpha[4]
    reads = [bytes(arr[p : p + 90]) for p in rng.integers(0, 19000, 25)]

    for k, stride in ((20, 1), (20, 4), (11, 2)):
        monkeypatch.setenv("THERMITE_PACKED_MIN", "1")
        ep = NativeSmemEngine(arr, k, stride=stride)
        t = ep.export_table(views=True)
        assert isinstance(t, PackedSeedTable) and t[0] == ep.k
        er = NativeSmemEngine(arr, k, table=t)
        monkeypatch.setenv("THERMITE_PACKED_MIN", "999999999999")
        ec = NativeSmemEngine(arr, k, stride=stride)
        en = SmemEngine(arr, k, table=_unpack_packed_table(t))
        for r in reads:
            a = ep.all_smems(r)
            assert a == ec.all_smems(r) == er.all_smems(r) == en.all_smems(r)

    # artifact round trip with a packed table
    monkeypatch.setenv("THERMITE_PACKED_MIN", "1")
    from tests.fixtures import write_fixture

    from thermite.index.build import Index

    fasta, gtf, _ = write_fixture(tmp_path)
    idx = Index.create_from_files(fasta, gtf)
    idx.build_seed_table(stride=1)
    assert isinstance(idx.seed_table, PackedSeedTable)
    art = tmp_path / "packed.npz"
    idx.save(str(art))
    idx2 = Index.load(str(art))
    assert isinstance(idx2.seed_table, PackedSeedTable)
    assert (np.asarray(idx2.seed_table.kv)
            == np.asarray(idx.seed_table.kv)).all()
    # the persisted pfx prefix rides along and equals the built one
    # (its adoption skips the full-kv count pass at engine start)
    assert idx2.seed_table.pfx is not None
    assert (np.asarray(idx2.seed_table.pfx)
            == np.asarray(idx.seed_table.pfx)).all()
    from thermite.seed.native import make_seeder

    monkeypatch.setenv("THERMITE_PACKED_MIN", "999999999999")
    fresh = make_seeder(idx2.seq_arr, 20)
    restored = make_seeder(idx2.seq_arr, 20, table=idx2.seed_table)
    read = idx.seq[30:120]
    assert restored.all_smems(read) == fresh.all_smems(read)


def test_mmap_artifact_load_identity(tmp_path):
    """Index.load(mmap=True) (the default: members memory-mapped from
    the uncompressed npz) must behave identically to the materialized
    load — text slicing, seeding, and the seed table arrays."""
    import numpy as np

    from tests.fixtures import write_fixture

    from thermite.index.build import Index

    fasta, gtf, _ = write_fixture(tmp_path)
    idx = Index.create_from_files(fasta, gtf)
    idx.build_seed_table(stride=1)
    art = tmp_path / "mm.npz"
    idx.save(str(art))

    a = Index.load(str(art))  # mmap default
    b = Index.load(str(art), mmap=False)
    assert isinstance(a.seq_arr, np.memmap)
    assert len(a.seq) == len(b.seq)
    assert a.seq[5:40] == b.seq[5:40] and isinstance(a.seq[5:40], bytes)
    assert a.seq[7] == b.seq[7] and isinstance(a.seq[7], int)
    for x, y in zip(a.seed_table[1:], b.seed_table[1:]):
        assert (np.asarray(x) == np.asarray(y)).all()
    from thermite.seed.native import make_seeder

    read = b.seq[10:100]
    sa = make_seeder(a.seq_arr, 20, table=a.seed_table).all_smems(read)
    sb = make_seeder(b.seq_arr, 20, table=b.seed_table).all_smems(read)
    assert sa == sb and len(sa) > 0


def test_artifact_ref_text_reused_by_aligner(tmp_path):
    """Current artifacts store genome+tx text as one `ref_text` member;
    the aligner must reuse that mapping (no multi-GB concat at load)
    and produce identical alignments to an in-memory index."""
    import numpy as np

    from tests.fixtures import write_fixture

    from thermite.align.batch import BatchAligner
    from thermite.align.driver import AlignOpts
    from thermite.index.build import Index

    fasta, gtf, _ = write_fixture(tmp_path)
    idx = Index.create_from_files(fasta, gtf)
    art = tmp_path / "rt.npz"
    idx.save(str(art))
    idx2 = Index.load(str(art))
    assert idx2.ref_text_arr is not None
    assert len(idx2.ref_text_arr) == len(idx.seq) + sum(
        len(t.seq) for t in idx.txome.txs
    )
    opts = AlignOpts(
        min_seed_len=3, min_aln_score_percent=0.0, min_aln_score=0,
        intron_mode=True,
    )
    ba = BatchAligner(idx2, opts, backend="xla")
    assert np.shares_memory(ba._ref_text_host, idx2.ref_text_arr)
    # the artifact's packed device text must equal a fresh pack
    from thermite.ops.layout import pack_text_nib_host

    assert idx2.text_nib_arr is not None
    assert np.array_equal(
        idx2.text_nib_arr, pack_text_nib_host(np.asarray(idx2.ref_text_arr))
    )
    ba_mem = BatchAligner(idx, opts, backend="xla")
    read = idx.seq[4:60]
    a = ba.align_batch([read])[0]
    b = ba_mem.align_batch([read])[0]
    assert [(g.ref_name, g.gx_aln.ystart, g.gx_aln.score) for g in a] == [
        (g.ref_name, g.gx_aln.ystart, g.gx_aln.score) for g in b
    ] and len(a) > 0


def test_acgtn_guard_and_saved_scan(tmp_path):
    """The stream route's nibble-safety guard still fires for dirty texts, and
    a clean artifact's save-time scan spares the aligner's own pass."""
    import numpy as np
    import pytest

    from tests.fixtures import write_fixture

    from thermite.align.batch import BatchAligner
    from thermite.align.driver import AlignOpts
    from thermite.index.build import Index

    fasta, gtf, _ = write_fixture(tmp_path)
    idx = Index.create_from_files(fasta, gtf)
    art = tmp_path / "ok.npz"
    idx.save(str(art))
    idx2 = Index.load(str(art))
    assert idx2.text_acgtn_ok  # clean fixture: scan recorded at save
    opts = AlignOpts(
        min_seed_len=3, min_aln_score_percent=0.0, min_aln_score=0,
        intron_mode=True,
    )
    BatchAligner(idx2, opts, backend="stream")  # no raise

    # a dirty text must still be refused by the stream route
    dirty = tmp_path / "dirty.fasta"
    dirty.write_text(">c1\n" + "ACGTR" * 40 + "\n")
    idx3 = Index.create_from_files(str(dirty), gtf)
    assert not getattr(idx3, "text_acgtn_ok", False)
    with pytest.raises(NotImplementedError, match="non-ACGTN"):
        BatchAligner(idx3, opts, backend="stream")


def test_export_views_match_copies():
    """export_table(views=True) — the zero-copy path the genome-scale
    index build uses — must be element-identical to the copying
    export, read-only, and stay valid while the engine lives."""
    import numpy as np

    from thermite.seed.native import NativeSmemEngine

    rng = np.random.default_rng(11)
    arr = rng.choice(np.frombuffer(b"ACGT", np.uint8), 4000)
    eng = NativeSmemEngine(arr, 11, stride=2)
    copies = eng.export_table()
    views = eng.export_table(views=True)
    assert views[0] == copies[0]
    for v, c in zip(views[1:], copies[1:]):
        assert v.dtype == np.int64 and not v.flags.writeable
        assert (v == c).all()


def test_strided_table_parity_and_recall():
    """stride > 1 (whole-genome sampling): C++ and numpy engines agree
    at the same stride, and every maximal match of length
    >= k + stride - 1 is still found (the sampling guarantee)."""
    import numpy as np

    from thermite.seed.native import NativeSmemEngine
    from thermite.seed.smem import SmemEngine

    rng = np.random.default_rng(42)
    arr = rng.choice(np.frombuffer(b"ACGT", np.uint8), 6000)
    text = arr.tobytes()
    k, stride = 20, 4
    native = NativeSmemEngine(arr, k, stride=stride)
    ref = SmemEngine(arr, k, stride=stride)
    full = SmemEngine(arr, k)  # stride-1 referee

    for start in range(100, 2000, 137):
        for rlen in (k + stride - 1, 30, 60):
            read = text[start : start + rlen]
            got = native.all_smems(read)
            assert got == ref.all_smems(read)
            # guaranteed recall: matches of length >= k + stride - 1
            want = {
                (m.query_idx, m.ref_idx, m.len)
                for m in full.all_smems(read)
                if m.len >= k + stride - 1
            }
            have = {(m.query_idx, m.ref_idx, m.len) for m in got}
            assert want <= have, (start, rlen)


def test_warm_mmap_roundtrip(monkeypatch, tmp_path):
    """Index.warm_mmap streams every memmap-backed member (seed table —
    classic tuple AND packed forms — plus ref_text/text_nib) without
    error and is a no-op on eagerly-loaded indexes."""
    from tests.fixtures import write_fixture

    from thermite.index.build import Index

    ref, gtf, _ = write_fixture(tmp_path)
    idx = Index.create_from_files(ref, gtf)
    assert idx.warm_mmap() >= 0.0  # nothing mapped: no-op

    art = str(tmp_path / "warm_classic.npz")
    idx.save(art)
    loaded = Index.load(art)  # mmap=True default
    assert loaded.warm_mmap() >= 0.0

    monkeypatch.setenv("THERMITE_PACKED_MIN", "1")
    idx2 = Index.create_from_files(ref, gtf)
    art2 = str(tmp_path / "warm_packed.npz")
    idx2.save(art2)
    packed = Index.load(art2)
    from thermite.seed.native import PackedSeedTable

    assert isinstance(packed.seed_table, PackedSeedTable)
    assert packed.warm_mmap() >= 0.0
    # the warmed index still searches identically
    eager = Index.load(art, mmap=False)
    chrom = bytes(loaded.seq[:200])
    assert loaded.seq_slice(0, 50) == eager.seq_slice(0, 50)
    assert len(chrom) == 200


def test_prep_reads_and_nib_pack_native(tmp_path):
    """thermite_prep_reads == the old Python fill loop (uppercase,
    zero padding, lengths); thermite_nib_pack_reads ==
    pack_reads_nib_host bit for bit."""
    from tests.fixtures import write_fixture

    from thermite.align.batch import BatchAligner
    from thermite.align.driver import AlignOpts
    from thermite.index.build import Index
    from thermite.ops.layout import pack_reads_nib_host

    fasta, gtf, _ = write_fixture(tmp_path)
    idx = Index.create_from_files(fasta, gtf)
    eng = BatchAligner(idx, AlignOpts(min_seed_len=3), backend="xla").native
    if eng is None:
        pytest.skip("native engine unavailable")
    rng = np.random.default_rng(3)
    reads = [
        bytes(rng.choice(np.frombuffer(b"acgtACGTNrX$", np.uint8), int(n)))
        for n in rng.integers(1, 40, 37)
    ] + [b"", b"acgt"]
    RPAD, rows = 48, 64
    pad, lens = eng.prep_reads(reads, rows, RPAD)
    want = np.zeros((rows, RPAD), np.uint8)
    for i, r in enumerate(reads):
        u = r.upper()
        want[i, : len(u)] = np.frombuffer(u, np.uint8)
        assert lens[i] == len(r)
    assert (pad == want).all()
    assert (
        eng.nib_pack_reads(pad) == pack_reads_nib_host(pad.reshape(-1))
    ).all()
