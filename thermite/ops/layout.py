"""Device data layout shared by every engine: the nibble-packed resident
text and read block, the per-problem meta rows, the stream-row header,
and the traceback direction codes.

Host packers (numpy) and device unpackers / window gathers (plain XLA)
live side by side so the two ends of each layout are defined once.

Problem meta (9 int32 columns, ``META_COLS``)::

    [y_word, y_sub, y_dir, ylen, x_base, x_dir, xlen, band, x_drop]

The y anchor is pre-split into (word, sub) of the nibble-packed text:
anchor byte = 8*y_word + y_sub = text position + _WPAD.  Splitting on
the host keeps every device-side quantity int32 for texts up to
~17 Gbp (word indices < 2^31) without 64-bit JAX.  The window in
forward text order is ``[anchor, anchor+ylen)`` for y_dir = +1 and
``[anchor-(ylen-1), anchor]`` read reversed for y_dir = -1; x likewise
in byte offsets of the read block.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# traceback direction codes (2 bits each in the packed op streams)
DIR_MATCH = 0
DIR_SUBST = 1
DIR_DEL = 2
DIR_INS = 3

# Zero bytes padding both ends of the packed text and read block, so
# reversed windows near position 0 never index out of range.  Windows
# longer than this need a wider pad (see ``check_window``).
_WPAD = 512

META_COLS = 9  # y_word, y_sub, y_dir, ylen, x_base, x_dir, xlen, band, x_drop

# packed upload form: 4 int32 cols [y_word, x_base,
#   ylen | xlen<<16,  y_sub | ydir_neg<<3 | xdir_neg<<4 | band<<5 | xd<<15]
# unpacked on device by ``meta9`` (a handful of shifts)
META_PACKED_COLS = 4


def check_window(XMAX: int, YMAX: int) -> None:
    if XMAX > _WPAD or YMAX > _WPAD:
        raise ValueError(
            f"window ({XMAX}, {YMAX}) exceeds the text padding {_WPAD}; "
            "long-read support needs a wider _WPAD"
        )


def pack_meta_host(meta: np.ndarray) -> np.ndarray:
    """(N, 9) int32 problem meta -> (N, 4) packed upload form."""
    m = meta
    assert m.shape[1] == META_COLS
    ylen, xlen = m[:, 3], m[:, 6]
    band, xd = m[:, 7], m[:, 8]
    if len(m) and (
        int(ylen.max(initial=0)) > 0xFFFF or int(xlen.max(initial=0)) > 0xFFFF
        or int(band.max(initial=0)) > 0x3FF or int(xd.max(initial=0)) > 0xFFF
    ):
        raise ValueError("meta fields exceed packed-form ranges")
    c2 = ylen | (xlen << 16)
    c3 = (
        m[:, 1]
        | ((m[:, 2] < 0).astype(np.int32) << 3)
        | ((m[:, 5] < 0).astype(np.int32) << 4)
        | (band << 5)
        | (xd << 15)
    )
    return np.stack([m[:, 0], m[:, 4], c2, c3], axis=1).astype(np.int32)


def meta9(meta):
    """Device-side: accept (N, 9) unpacked or (N, 4) packed meta and
    return the canonical 9-col layout (pad rows of zeros unpack to
    zeros except dir = +1, which only affects discarded pad outputs)."""
    if meta.shape[1] == META_COLS:
        return meta
    c0, c1, c2, c3 = (meta[:, k : k + 1] for k in range(META_PACKED_COLS))
    ylen = c2 & 0xFFFF
    xlen = (c2 >> 16) & 0xFFFF
    y_sub = c3 & 7
    y_dir = 1 - 2 * ((c3 >> 3) & 1)
    x_dir = 1 - 2 * ((c3 >> 4) & 1)
    band = (c3 >> 5) & 0x3FF
    xd = (c3 >> 15) & 0xFFF
    return jnp.concatenate(
        [c0, y_sub, y_dir, ylen, c1, x_dir, xlen, band, xd], axis=1
    )


def params_from_meta(meta):
    """(N, 9) meta -> (N, 4) kernel params [xlen, ylen, band, x_drop]."""
    return jnp.concatenate(
        [meta[:, 6:7], meta[:, 3:4], meta[:, 7:8], meta[:, 8:9]], axis=1
    )


def meta_row(y_base, y_dir, ylen, x_base, x_dir, xlen, band, x_drop):
    """Build one META_COLS row from a byte-coordinate y anchor (test /
    dry-run helper; the batch builders inline this)."""
    lo = y_base + _WPAD
    return (lo >> 3, lo & 7, y_dir, ylen, x_base, x_dir, xlen, band, x_drop)


# The resident reference text is nibble-packed: 8 bases per int32 word,
# 4-bit codes, little-endian (code i at bits 4i..4i+3).  One copy, L/2
# bytes — a 6.2 Gbp fwd+rc whole-genome text is 3.1 GB.  Word straddles
# are resolved on-device with a per-problem funnel shift.
#
# 4-bit text codes: 0 = padding, A/C/G/T/N/$ = 1..6, anything else = 7.
# Read bytes map through _READ_NIB_LUT (A..N = 1..5, other = 15), so a
# non-ACGTN read byte never matches any text code — same outcome as the
# reference's byte compare on a clean ACGTN$ text.  Texts containing
# other bytes must use the byte-path XLA backend (BatchAligner guards).
_NIB_LUT = np.full(256, 7, np.uint8)
_NIB_LUT[0] = 0
for _i, _b in enumerate(b"ACGTN$"):
    _NIB_LUT[_b] = _i + 1

_READ_NIB_LUT = np.full(256, 15, np.uint8)
_READ_NIB_LUT[0] = 0
for _i, _b in enumerate(b"ACGTN"):
    _READ_NIB_LUT[_b] = _i + 1


def nib_lw(L: int) -> int:
    """Word count of the nibble-packed text for L bytes."""
    return (_WPAD + L + _WPAD + 7) // 8


def _pack_nib(u8: np.ndarray, lut: np.ndarray) -> np.ndarray:
    L = int(u8.shape[0])
    Lw = nib_lw(L)
    padded = np.zeros(Lw * 8, np.uint8)
    padded[_WPAD : _WPAD + L] = u8
    w = np.zeros(Lw, np.uint32)
    for i in range(8):
        # per-slice LUT keeps the transient at Lw elements, not 8*Lw
        w |= lut[padded[i::8]].astype(np.uint32) << np.uint32(4 * i)
    return w.view(np.int32)


def pack_text_nib_host(text_u8: np.ndarray) -> np.ndarray:
    """Host-side nibble pack: (L,) uint8 ASCII -> (nib_lw(L),) int32.

    Word w holds codes of text_padded[8w .. 8w+7] where
    text_padded = [0]*_WPAD + text + [0]*pad."""
    return _pack_nib(text_u8, _NIB_LUT)


def pack_reads_nib_host(reads_u8: np.ndarray) -> np.ndarray:
    """Host-side nibble pack of the (rows*RPAD,) flattened read block,
    same word layout as ``pack_text_nib_host`` but through the READ code
    LUT (the native engine's ``nib_pack_reads`` is its bit-identical
    twin)."""
    return _pack_nib(reads_u8, _READ_NIB_LUT)


def iter_text_nib_words(text_u8: np.ndarray, chunk_words: int = 1 << 26):
    """Yield ``pack_text_nib_host(text_u8)`` in int32 chunks.

    Streaming form for persisting a genome-scale packed text (the
    artifact's ``text_nib`` member): the whole-array pack transiently
    allocates ~2.5x the text; chunks keep the transient at ~0.6 GB.
    Element-exact equality with the one-shot pack is pinned by test."""
    L = int(text_u8.shape[0])
    Lw = nib_lw(L)
    for a in range(0, Lw, chunk_words):
        b = min(a + chunk_words, Lw)
        padded = np.zeros((b - a) * 8, np.uint8)
        lo = 8 * a - _WPAD  # text coordinate of padded-chunk byte 0
        s = max(lo, 0)
        e = min(8 * b - _WPAD, L)
        if e > s:
            padded[s - lo : e - lo] = text_u8[s:e]
        w = np.zeros(b - a, np.uint32)
        for i in range(8):
            w |= _NIB_LUT[padded[i::8]].astype(np.uint32) << np.uint32(4 * i)
        yield w.view(np.int32)


def gather_span_nib(words_flat, lw, w0, sub, dirp, SPAN):
    """(N,1) word/sub anchor + dir -> (N, SPAN) uint8 codes.

    For dir=+1 the anchor is the window start; for dir=-1 it is the
    window END in forward order and the output is reversed (y[i] =
    text[anchor - i])."""
    q = jnp.where(dirp == 1, sub, sub - (SPAN - 1))
    adj = jnp.floor_divide(q, 8)  # floor: q may be negative
    ws = w0 + adj
    s = q - 8 * adj  # 0..7
    K = (SPAN + 7) // 8
    k = jnp.arange(K + 1, dtype=jnp.int32)[None, :]
    idx = jnp.clip(ws + k, 0, lw - 1)
    words = jnp.take(words_flat, idx).astype(jnp.uint32)  # (N, K+1)
    sh = (4 * s).astype(jnp.uint32)
    lo = words[:, :K] >> sh
    hi_sh = ((32 - 4 * s) % 32).astype(jnp.uint32)
    hi = jnp.where(s == 0, jnp.uint32(0), words[:, 1:] << hi_sh)
    w = lo | hi  # (N, K): 8 window codes per word
    nib_sh = (4 * jnp.arange(8, dtype=jnp.uint32))[None, None, :]
    b = ((w[:, :, None] >> nib_sh) & 0xF).astype(jnp.uint8)
    b = b.reshape(b.shape[0], 8 * K)[:, :SPAN]
    return jnp.where(dirp == 1, b, jnp.flip(b, axis=1))


def gather_windows(ref_nib, ref_lw, reads_nib, meta, XMAX, YMAX):
    """Device window builder: x (N, XMAX) from the nibble-packed read
    block, y (N, YMAX) from the nibble-packed resident text, both as
    comparable 4-bit codes, zero beyond xlen / ylen."""
    lo = meta[:, 4:5] + _WPAD
    xb = gather_span_nib(
        reads_nib, reads_nib.shape[0], lo >> 3, lo & 7, meta[:, 5:6], XMAX
    )
    ix = jnp.arange(XMAX, dtype=jnp.int32)[None, :]
    x = jnp.where(ix < meta[:, 6:7], xb, 0).astype(jnp.uint8)
    yb = gather_span_nib(
        ref_nib.reshape(-1), ref_lw, meta[:, 0:1], meta[:, 1:2],
        meta[:, 2:3], YMAX,
    )
    iy = jnp.arange(YMAX, dtype=jnp.int32)[None, :]
    y = jnp.where(iy < meta[:, 3:4], yb, 0).astype(jnp.uint8)
    return x, y


def pack_stream_hdr(meta4):
    """Device epilogue: (N, 4) int32 [score, max_i, max_j, nsteps] ->
    (N, 2) int32 with int16 halves [score|max_i, max_j|nsteps] — every
    field fits int16 for reads under the _WPAD guard, so the always-
    transferred per-problem header halves.  Host: expand_stream_hdr."""
    ms, mi, mj, ns = (meta4[:, k : k + 1] for k in range(4))
    w0 = (ms & 0xFFFF) | (mi << 16)
    w1 = (mj & 0xFFFF) | (ns << 16)
    return jnp.concatenate([w0, w1], axis=1)


def expand_stream_hdr(sub2: np.ndarray) -> np.ndarray:
    """(n, 2) int32 packed headers -> (n, 4) int32 (sign-extended)."""
    return (
        np.ascontiguousarray(sub2).view(np.int16).astype(np.int32)
    ).reshape(len(sub2), 4)
