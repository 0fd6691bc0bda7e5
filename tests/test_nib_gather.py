"""Nibble-packed resident-text gather: the whole-genome device layout.

``pack_text_nib_host`` + ``gather_span_nib`` hold the text as 4-bit
codes (0.5 byte/base), keeping every device-side index int32 up to
~17 Gbp texts.  The gather is plain XLA (runs on CPU here); these tests pin it
against a direct numpy reconstruction, including reversed windows,
word-straddling offsets, and text-edge clipping.
"""

import numpy as np
import pytest

from thermite.ops.layout import (
    _NIB_LUT,
    _READ_NIB_LUT,
    _WPAD,
    gather_span_nib,
    gather_windows,
    meta_row,
    nib_lw,
    pack_reads_nib_host,
    pack_text_nib_host,
)


def _ref_codes(text, base, dirp, span):
    """Numpy reference: codes of text[base + dirp*i] with zero padding
    outside [0, len)."""
    out = np.zeros(span, np.uint8)
    for i in range(span):
        p = base + dirp * i
        if 0 <= p < len(text):
            out[i] = _NIB_LUT[text[p]]
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_gather_span_nib_matches_numpy(seed):
    rng = np.random.default_rng(seed)
    text = rng.choice(np.frombuffer(b"ACGTN$", np.uint8), 3000)
    words = pack_text_nib_host(text)
    lw = nib_lw(len(text))
    SPAN = 64

    cases = []
    for _ in range(200):
        base = int(rng.integers(0, len(text)))
        cases.append((base, 1))
        cases.append((base, -1))
    # edges: reversed window at position 0, forward at the end
    cases += [(0, -1), (2, -1), (len(text) - 1, 1), (len(text) - 3, 1)]

    N = len(cases)
    w0 = np.zeros((N, 1), np.int32)
    sub = np.zeros((N, 1), np.int32)
    dirp = np.zeros((N, 1), np.int32)
    for i, (base, d) in enumerate(cases):
        lo = base + _WPAD
        w0[i], sub[i], dirp[i] = lo >> 3, lo & 7, d
    got = np.asarray(gather_span_nib(words, lw, w0, sub, dirp, SPAN))
    for i, (base, d) in enumerate(cases):
        want = _ref_codes(text, base, d, SPAN)
        assert (got[i] == want).all(), (i, base, d)


def test_read_codes_mapping():
    got = _READ_NIB_LUT[np.frombuffer(b"ACGTN\x00RQ$", np.uint8)]
    # ACGTN -> 1..5, pad 0 -> 0, anything else (incl '$') -> 15: a read
    # byte outside ACGTN can never match a text code
    assert got.tolist() == [1, 2, 3, 4, 5, 0, 15, 15, 15]
    assert set(got.tolist()).isdisjoint(set(_NIB_LUT.tolist()) - {1, 2, 3, 4, 5, 0})


def test_gather_windows_pairs_with_ascii_path():
    """The full window builder produces code-mapped x and y that match
    byte-for-byte after code translation of a direct slice."""
    rng = np.random.default_rng(7)
    text = rng.choice(np.frombuffer(b"ACGT", np.uint8), 2000)
    words = pack_text_nib_host(text)
    lw = nib_lw(len(text))
    RPAD = 32
    B = 8
    reads = rng.choice(np.frombuffer(b"ACGT", np.uint8), (B, RPAD))
    XMAX, YMAX = 32, 64
    meta = np.zeros((2 * B, 9), np.int32)
    for i in range(B):
        p = int(rng.integers(100, len(text) - 100))
        meta[2 * i] = meta_row(p, 1, 40, i * RPAD + 4, 1, RPAD - 4, 8, 8)
        meta[2 * i + 1] = meta_row(p - 1, -1, 12, i * RPAD + 3, -1, 4, 8, 8)
    nib = pack_reads_nib_host(reads.reshape(-1))
    x, y = (np.asarray(v) for v in gather_windows(words, lw, nib, meta, XMAX, YMAX))
    flat = reads.reshape(-1)
    for r in range(2 * B):
        yw, ys, yd, yl, xb, xd, xl = meta[r, :7]
        base = 8 * int(yw) + int(ys) - _WPAD
        want_y = _ref_codes(text, base, int(yd), YMAX)
        want_y[yl:] = 0
        assert (y[r] == want_y).all(), r
        # x: code-mapped, masked beyond xlen
        want_x = np.zeros(XMAX, np.uint8)
        for i in range(int(xl)):
            want_x[i] = _READ_NIB_LUT[flat[int(xb) + int(xd) * i]]
        assert (x[r] == want_x).all(), r


def test_iter_text_nib_words_matches_one_shot():
    """The streaming packer (artifact text_nib member) must be
    element-exact vs pack_text_nib_host across chunk boundaries and
    ragged tails."""
    from thermite.ops.layout import iter_text_nib_words

    rng = np.random.default_rng(4)
    for L in (1, 7, 8191, 100_003):
        text = rng.choice(np.frombuffer(b"ACGTN$", np.uint8), L).astype(
            np.uint8
        )
        one = pack_text_nib_host(text)
        for cw in (97, 1 << 12):
            chunks = np.concatenate(
                list(iter_text_nib_words(text, chunk_words=cw))
            )
            assert np.array_equal(chunks, one), (L, cw)


def test_prepacked_reads_match_byte_path():
    """Production read form: the nibble-packed read block gathers to the
    READ code of every byte, including reversed windows, non-ACGTN read
    bytes, pad bytes inside the block, block-edge anchors and spans that
    are not a multiple of the 8-code word."""
    rng = np.random.default_rng(11)
    text = rng.choice(np.frombuffer(b"ACGT", np.uint8), 4000)
    words = pack_text_nib_host(text)
    lw = nib_lw(len(text))
    RPAD = 48
    B = 16
    reads = rng.choice(np.frombuffer(b"ACGTNRX", np.uint8), (B, RPAD))
    reads[3, 5:] = 0  # short read: pad bytes inside the block
    flat = reads.reshape(-1)
    meta = np.zeros((2 * B, 9), np.int32)
    for i in range(B):
        p = int(rng.integers(150, len(text) - 150))
        xl = int(rng.integers(1, RPAD))
        meta[2 * i] = meta_row(p, 1, 60, i * RPAD, 1, xl, 8, 8)
        meta[2 * i + 1] = meta_row(
            p - 1, -1, 20, i * RPAD + xl - 1, -1, xl, 8, 8
        )
    # edge: reversed x window anchored at byte 0 of the block
    meta[1] = meta_row(200, -1, 20, 0, -1, 1, 8, 8)
    nib = pack_reads_nib_host(flat)
    for XMAX in (48, 45):
        x, _ = (np.asarray(v) for v in gather_windows(words, lw, nib, meta, XMAX, 96))
        for r in range(2 * B):
            xb, xd, xl = (int(v) for v in meta[r, 4:7])
            want = np.zeros(XMAX, np.uint8)
            for i in range(min(xl, XMAX)):
                want[i] = _READ_NIB_LUT[flat[xb + xd * i]]
            assert (x[r] == want).all(), (XMAX, r)
