"""Adaptive narrow-band pass: C++ scalar SWG oracle parity, kernel
exactness certificate, and end-to-end narrow-vs-wide identity.

The production pipeline submits extension problems at a capped band
(``BatchAligner.narrow_band``) and relies on the stream kernel's
per-problem certificate (``ops/stream.py`` docstring) to prove the
result identical to the full-band run; failures are host-patched by the
C++ scalar oracle (csrc/thermite_native.cpp swg_stream_row, an exact
mirror of ops/swg_ref.py / reference src/swg.rs:31-240).
"""

import ctypes

import numpy as np
import pytest

from thermite.align import native_batch
from thermite.ops.runs import decode_stream_batch
from thermite.ops.swg_ref import SwgExtend
from thermite.seed.native import _try_load

_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def _lib():
    lib = _try_load()
    if lib is None:
        pytest.skip("native library unavailable")
    native_batch._setup(lib)
    return lib


def _np_arr(b: bytes):
    return np.frombuffer(b, np.uint8) if b else np.zeros(0, np.uint8)


def _cpp_stream(lib, x: bytes, y: bytes, band: int, xd: int, pw: int = 64):
    out = np.zeros(4 + pw, np.int32)
    xa, ya = _np_arr(x), _np_arr(y)
    rc = lib.thermite_swg_stream(
        xa.ctypes.data_as(_u8p), len(x), ya.ctypes.data_as(_u8p), len(y),
        band, xd, out.ctypes.data_as(_i32p), pw,
    )
    assert rc == 0
    return out


def test_cpp_swg_matches_oracle():
    """C++ swg_stream == Python oracle (score, max cell, full op list)
    over random and correlated pairs, mixed bands and x-drops."""
    lib = _lib()
    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", np.uint8)
    for trial in range(200):
        xlen = int(rng.integers(0, 120))
        ylen = int(rng.integers(0, 200))
        band = int(rng.integers(1, 64))
        xd = int(rng.integers(1, 80))
        x = rng.choice(bases, xlen).tobytes()
        if trial % 2 and xlen and ylen:
            yb = bytearray(x[: min(xlen, ylen)].ljust(ylen, b"A"))
            for _ in range(int(rng.integers(0, 6))):
                yb[int(rng.integers(0, ylen))] = int(rng.choice(bases))
            y = bytes(yb)
        else:
            y = rng.choice(bases, ylen).tobytes()
        out = _cpp_stream(lib, x, y, band, xd)
        ref = SwgExtend(band).extend(x, y, band, xd)
        aln = decode_stream_batch(
            out[None, :], np.array([xlen]), np.array([ylen])
        )[0]
        assert (aln.score, aln.xend, aln.yend) == (
            ref.score, ref.xend, ref.yend,
        ), trial
        assert aln.operations == ref.operations, trial


def test_cpp_adaptive_matches_full():
    """C++ adaptive narrow-band (swg_stream_row_adaptive) is bit-identical
    to the full-band scalar SWG on every input — certificate accepts run
    narrow, failures recompute at full band — and both outcomes occur in
    a mixed corpus (clean flanks certify; >narrow-band indels patch)."""
    lib = _lib()
    lib.thermite_swg_stream_adaptive.restype = ctypes.c_int64
    lib.thermite_swg_stream_adaptive.argtypes = [
        _u8p, ctypes.c_int64, _u8p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, _i32p, ctypes.c_int64, _i64p,
    ]
    rng = np.random.default_rng(3)
    bases = np.frombuffer(b"ACGT", np.uint8)
    pw = 64
    NARROW = 15
    patched = ctypes.c_int64(0)
    n_narrowable = 0
    for trial in range(400):
        xlen = int(rng.integers(0, 110))
        band = int(rng.integers(1, 64))
        ylen = min(int(rng.integers(0, 200)), xlen + band + 1)
        xd = int(rng.integers(1, 80))
        x = rng.choice(bases, xlen).tobytes()
        kind = trial % 4
        if kind == 0 or not (xlen and ylen):
            y = rng.choice(bases, ylen).tobytes()  # unrelated
        elif kind == 1:  # near-copy: should certify at narrow band
            yb = bytearray(x[:min(xlen, ylen)].ljust(ylen, b"A"))
            for _ in range(int(rng.integers(0, 4))):
                yb[int(rng.integers(0, ylen))] = int(rng.choice(bases))
            y = bytes(yb)
        else:  # copy with a >NARROW-band gap: certificate must fail
            cut = int(rng.integers(0, max(xlen - 1, 1)))
            gap = int(rng.integers(NARROW + 2, NARROW + 30))
            yb = x[:cut] + rng.choice(bases, gap).tobytes() + x[cut:]
            y = yb[:ylen].ljust(ylen, b"A")
        xa, ya = _np_arr(x), _np_arr(y)
        full = _cpp_stream(lib, x, y, band, xd, pw)
        ada = np.zeros(4 + pw, np.int32)
        rc = lib.thermite_swg_stream_adaptive(
            xa.ctypes.data_as(_u8p), xlen, ya.ctypes.data_as(_u8p), len(y),
            band, NARROW, xd, ada.ctypes.data_as(_i32p), pw,
            ctypes.byref(patched),
        )
        assert rc == 0, trial
        assert (ada == full).all(), trial
        n_narrowable += band > NARROW
    # both regimes genuinely exercised
    assert patched.value > 0
    assert patched.value < n_narrowable


def _mk_problems(rng, n, wide, with_indels=True):
    """Synthetic text/reads/meta at ``wide`` band; some reads carry
    >narrow-band indels so certificate failures actually occur."""
    from thermite.ops.layout import (
        meta_row, nib_lw, pack_reads_nib_host, pack_text_nib_host,
    )

    text = rng.choice(np.frombuffer(b"ACGT", np.uint8), 200_000)
    words = pack_text_nib_host(text)
    lw = np.int32(nib_lw(len(text)))
    RPAD, NR = 96, 128
    reads = np.zeros((NR, RPAD), np.uint8)
    src = np.zeros(NR, np.int64)
    for i in range(NR):
        p = int(rng.integers(200, len(text) - 400))
        src[i] = p
        r = text[p : p + 90].copy()
        for _ in range(int(rng.integers(0, 4))):
            r[int(rng.integers(0, 90))] = ord(rng.choice(list("ACGT")))
        if with_indels and i % 8 == 0:
            cut = int(rng.integers(20, 60))
            r = np.concatenate(
                [text[p : p + cut], text[p + cut + 25 : p + cut + 25 + 90 - cut]]
            )
        reads[i, :90] = r[:90]
    meta = np.zeros((n, 9), np.int32)
    for i in range(n):
        xlen = int(rng.integers(1, 91))
        ri = int(rng.integers(0, NR))
        q = int(rng.integers(0, 91 - xlen))
        ylen = min(xlen + wide + 1, 200)
        d = 1 if rng.random() < 0.5 else -1
        ybase = int(src[ri]) + q if d == 1 else int(src[ri]) + q + xlen
        meta[i] = meta_row(ybase, d, ylen, ri * RPAD + q, d, xlen, wide, wide)
    return text, words, lw, reads, pack_reads_nib_host(reads.reshape(-1)), meta


def _patch(lib, text, reads, meta_orig, rows, pids, smax):
    from thermite.ops.layout import _WPAD

    pids = np.ascontiguousarray(pids, np.int64)
    rc = lib.thermite_swg_patch_rows(
        text.ctypes.data_as(_u8p), len(text),
        reads.reshape(-1).ctypes.data_as(_u8p), reads.size,
        np.ascontiguousarray(meta_orig, np.int32).ctypes.data_as(_i32p),
        pids.ctypes.data_as(_i64p), len(pids),
        _WPAD, rows.ctypes.data_as(_i32p), smax // 16,
    )
    assert rc == 0


def _stream_rows(kern, words, lw, nib, meta):
    """Fused [hdr expanded to 4 cols | streams] host rows."""
    from thermite.ops.layout import expand_stream_hdr

    hdr, streams = (np.asarray(v) for v in kern(words, lw, nib, meta))
    return np.concatenate([expand_stream_hdr(hdr), streams], axis=1)


@pytest.mark.parametrize("seed", [7, 11])
def test_narrow_cert_patch_equals_wide(seed):
    """Narrow-band stream kernel + certificate + C++ patch reproduces
    the wide-band kernel output bit-exactly, including problems with
    out-of-narrow-band indels."""
    from thermite.ops.stream import get_stream_kernel, width_for_band

    lib = _lib()
    rng = np.random.default_rng(seed)
    WIDE, NARROW, N, SMAX = 60, 15, 32, 384
    text, words, lw, reads, nib, meta_w = _mk_problems(rng, N, WIDE)
    meta_n = meta_w.copy()
    np.minimum(meta_n[:, 7], NARROW, out=meta_n[:, 7])
    np.minimum(meta_n[:, 3], meta_n[:, 6] + meta_n[:, 7] + 1, out=meta_n[:, 3])

    kw = get_stream_kernel(96, 192, width_for_band(WIDE), SMAX)
    kn = get_stream_kernel(96, 128, width_for_band(NARROW), SMAX)
    out_w = _stream_rows(kw, words, lw, nib, meta_w)
    out_n = _stream_rows(kn, words, lw, nib, meta_n)

    bad_n = np.flatnonzero(out_n[:, 3] < 0)
    # indel reads must actually exercise the patch path
    assert len(bad_n) > 0
    _patch(lib, text, reads, meta_w, out_n, bad_n, SMAX)
    # the wide kernel may flag its own (band-60-vs-wider) certificate;
    # production would patch those identically — do the same before
    # comparing
    bad_w = np.flatnonzero(out_w[:, 3] < 0)
    _patch(lib, text, reads, meta_w, out_w, bad_w, SMAX)
    assert (out_n == out_w).all()


def test_batch_aligner_narrow_parity(tmp_path_factory):
    """Full pipeline (native + stream route) with the narrow-band
    pass on vs off: identical alignments."""
    from fixtures import READS, write_fixture
    from thermite.align.batch import BatchAligner
    from thermite.align.driver import AlignOpts
    from thermite.index.build import Index

    _lib()
    ref, gtf, _ = write_fixture(tmp_path_factory.mktemp("nb"))
    index = Index.create_from_files(ref, gtf)
    reads = [seq.encode() for _, seq in READS]
    opts = AlignOpts(min_seed_len=3, min_aln_score=0, intron_mode=True)
    a_wide = BatchAligner(index, opts, backend="stream")
    a_wide.narrow_band = 0
    a_narrow = BatchAligner(index, opts, backend="stream")
    a_narrow.narrow_band = 4
    r_w = a_wide.align_batch(reads)
    r_n = a_narrow.align_batch(reads)
    assert a_narrow.stats.cert_patches >= 0
    assert r_w == r_n


def test_threaded_build_identity(tmp_path_factory):
    """thermite_chunk_build output is bit-identical at any thread count
    (per-read builds merge in input order with the same budget rule)."""
    import os

    from fixtures import READS, write_fixture
    from thermite.align.batch import BatchAligner
    from thermite.align.driver import AlignOpts
    from thermite.index.build import Index

    _lib()
    ref, gtf, _ = write_fixture(tmp_path_factory.mktemp("thr"))
    index = Index.create_from_files(ref, gtf)
    opts = AlignOpts(min_seed_len=3, min_aln_score=0, intron_mode=True)
    aligner = BatchAligner(index, opts, backend="xla", use_native=True)
    reads = [seq.encode() for _, seq in READS] * 40
    rpad = max(len(r) for r in reads)
    rpad = (rpad + 31) // 32 * 32
    reads_pad = np.zeros((len(reads), rpad), np.uint8)
    lens = np.zeros(len(reads), np.int64)
    for i, r in enumerate(reads):
        reads_pad[i, : len(r)] = np.frombuffer(r.upper(), np.uint8)
        lens[i] = len(r)

    outs = {}
    old = os.environ.get("THERMITE_THREADS")
    try:
        for n in ("1", "4"):
            os.environ["THERMITE_THREADS"] = n
            ch, consumed, meta, tasks = aligner.native.build_chunk(
                reads_pad, lens, len(reads), 300
            )
            aligner.native.free_chunk(ch)
            outs[n] = (consumed, meta, tasks)
    finally:
        if old is None:
            os.environ.pop("THERMITE_THREADS", None)
        else:
            os.environ["THERMITE_THREADS"] = old
    assert outs["1"][0] == outs["4"][0]
    assert (outs["1"][1] == outs["4"][1]).all()
    assert (outs["1"][2] == outs["4"][2]).all()
