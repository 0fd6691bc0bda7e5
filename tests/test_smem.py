"""SMEM seeding tests: anchor-gather engine vs brute-force definition."""

import numpy as np
import pytest

from thermite.seed.smem import SmemEngine, all_smems_brute


def _arr(seq: bytes) -> np.ndarray:
    return np.frombuffer(seq, dtype=np.uint8)


def test_simple_exact():
    text = b"ACGTACGTTTTT$"
    eng = SmemEngine(_arr(text), min_seed_len=4)
    mems = eng.all_smems(b"ACGT")
    # ACGT occurs at 0 and 4; single SMEM covering whole read
    assert [(m.query_idx, m.len, m.ref_idx) for m in mems] == [(0, 4, 0), (0, 4, 4)]


def test_matches_brute_random():
    rng = np.random.default_rng(0)
    alpha = b"ACGT"
    for trial in range(30):
        n = int(rng.integers(50, 300))
        text = bytes(alpha[i] for i in rng.integers(0, 4, n)) + b"$"
        L = int(rng.integers(10, 60))
        if rng.random() < 0.5:
            # embed a real substring with mutations for realistic matches
            p = int(rng.integers(0, n - min(L, n - 1)))
            read = bytearray(text[p : p + L].replace(b"$", b"A"))
            for _ in range(int(rng.integers(0, 4))):
                read[int(rng.integers(0, len(read)))] = alpha[int(rng.integers(0, 4))]
            read = bytes(read)
        else:
            read = bytes(alpha[i] for i in rng.integers(0, 4, L))
        for k in (3, 5, 13):
            got = SmemEngine(_arr(text), min_seed_len=k).all_smems(read)
            want = all_smems_brute(text, read, k)
            assert got == want, f"trial={trial} k={k} read={read!r}"


def test_n_matches_n():
    # 'N' in read matches literal 'N' in text (reference FM alphabet ACGNT).
    text = b"AANNAA$"
    eng = SmemEngine(_arr(text), min_seed_len=4)
    mems = eng.all_smems(b"ANNA")
    assert [(m.query_idx, m.len, m.ref_idx) for m in mems] == [(0, 4, 1)]


def test_sentinel_blocks_match():
    text = b"AAA$AAA$"
    eng = SmemEngine(_arr(text), min_seed_len=3)
    mems = eng.all_smems(b"AAAA")
    # no match of length 4 crosses the sentinel; SMEM is len-3 prefix env
    assert all(m.len == 3 for m in mems)
    assert {m.ref_idx for m in mems} == {0, 4}


def test_min_seed_len_filters():
    text = b"ACGTACGT$"
    eng = SmemEngine(_arr(text), min_seed_len=9)
    assert eng.all_smems(b"ACGTACGT") == []


def test_longest_smem():
    # parity surface for reference src/index.rs:260-283
    rng = np.random.default_rng(7)
    alpha = b"ACGT"
    for _ in range(20):
        n = int(rng.integers(60, 250))
        text = bytes(alpha[i] for i in rng.integers(0, 4, n)) + b"$"
        L = int(rng.integers(12, 50))
        p = int(rng.integers(0, max(n - L, 1)))
        read = bytearray(text[p : p + L].replace(b"$", b"A").ljust(L, b"C"))
        if rng.random() < 0.5 and L > 4:
            read[L // 2] = alpha[(alpha.index(read[L // 2]) + 1) % 4]
        read = bytes(read)
        eng = SmemEngine(_arr(text), min_seed_len=8)
        got = eng.longest_smem(read)
        ref = all_smems_brute(text, read, 8)
        if not ref:
            assert got is None
            continue
        best = max(m.len for m in ref)
        want = min(
            (m for m in ref if m.len == best),
            key=lambda m: (m.query_idx, m.ref_idx),
        )
        assert got == want


def test_longest_smem_none_below_min():
    eng = SmemEngine(_arr(b"ACGTACGTTTTT$"), min_seed_len=6)
    assert eng.longest_smem(b"ACGTA") is None
