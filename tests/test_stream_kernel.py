"""The single-pass stream kernel (ops/stream.py) against the scalar
oracle, its shape rules, the route choice around it, and — on a GPU —
the kernel as compiled for the card against the CPU compilation."""

import numpy as np
import pytest

from thermite.ops.layout import (
    meta_row,
    nib_lw,
    pack_meta_host,
    pack_reads_nib_host,
    pack_text_nib_host,
)
from thermite.ops.runs import decode_stream_batch
from thermite.ops.stream import get_stream_kernel, smax_for, stream_rows, width_for_band
from thermite.ops.swg_ref import SwgExtend


def pack_pairs(pairs, XMAX, YMAX):
    N = len(pairs)
    x = np.zeros((N, XMAX), np.uint8)
    y = np.zeros((N, YMAX), np.uint8)
    params = np.zeros((N, 4), np.int32)
    for k, (xs, ys, b, d) in enumerate(pairs):
        x[k, : len(xs)] = np.frombuffer(xs, np.uint8)
        y[k, : len(ys)] = np.frombuffer(ys, np.uint8)
        params[k] = (len(xs), len(ys), b, d)
    return x, y, params


def run_stream(pairs, W=None):
    XMAX = max(8, max(len(p[0]) for p in pairs))
    YMAX = max(8, max(len(p[1]) for p in pairs))
    W = W or width_for_band(max(p[2] for p in pairs))
    SMAX = smax_for(XMAX + YMAX)
    x, y, params = pack_pairs(pairs, XMAX, YMAX)
    meta4, streams = stream_rows(x, y, params, SMAX, W)
    return np.concatenate([np.asarray(meta4), np.asarray(streams)], axis=1), params


def assert_matches_oracle(pairs):
    rows, params = run_stream(pairs)
    stream = decode_stream_batch(rows, params[:, 0], params[:, 1])
    for (xs, ys, b, d), f, s in zip(pairs, rows, stream):
        want = SwgExtend(b).extend(xs, ys, b, d)
        assert (int(f[0]), int(f[1]), int(f[2])) == (want.score, want.xend, want.yend)
        assert s == want, (
            f"stream kernel: x={xs!r} y={ys!r} band={b} xdrop={d}\n got={s}\nwant={want}"
        )


def test_reference_cases():
    assert_matches_oracle(
        [
            (b"AAAAAAAA", b"AAAAAAAA", 1, 1),
            (b"AAAAATTT", b"AAAAAAAA", 1, 1),
            (b"AAATAAAA", b"AAAAAAAA", 1, 1),
            (b"AAATTTT", b"AAACCTTTT", 2, 3),
        ]
    )


def test_mixed_bands():
    assert_matches_oracle(
        [
            (b"ACGTACGT", b"ACGTACGT", 1, 1),
            (b"ACGTACGT", b"ACGGTACGT", 4, 8),
            (b"ACGT", b"TTTTTTTT", 2, 2),
            (b"A", b"A", 1, 1),
            (b"ACGTACGTACGT", b"ACG", 3, 3),
        ]
    )


def _fuzz_pairs(rng, n, max_band=10):
    alpha = b"ACGT"
    pairs = []
    for _ in range(n):
        xl = int(rng.integers(1, 32))
        yl = int(rng.integers(1, 48))
        if rng.random() < 0.6:
            base = bytes(alpha[c] for c in rng.integers(0, 4, max(xl, yl)))
            xs = bytearray(base[:xl])
            ys = bytearray(base[:yl])
            for _ in range(int(rng.integers(0, 5))):
                m = int(rng.integers(0, 3))
                if m == 0 and len(ys) > 1:
                    del ys[int(rng.integers(0, len(ys)))]
                elif m == 1:
                    ys.insert(int(rng.integers(0, len(ys))), alpha[int(rng.integers(0, 4))])
                elif len(ys) > 0:
                    ys[int(rng.integers(0, len(ys)))] = alpha[int(rng.integers(0, 4))]
            xs, ys = bytes(xs), bytes(ys)
        else:
            xs = bytes(alpha[c] for c in rng.integers(0, 4, xl))
            ys = bytes(alpha[c] for c in rng.integers(0, 4, yl))
        b = int(rng.integers(1, max_band))
        d = int(rng.integers(1, 15))
        pairs.append((xs, ys, b, d))
    return pairs


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_vs_oracle(seed):
    assert_matches_oracle(_fuzz_pairs(np.random.default_rng(seed + 100), 24))


def test_rows_do_not_depend_on_width():
    """Slots beyond 2*band+1 are masked: padding the band width (W 32 vs
    64) gives the same rows bit for bit, certificate included."""
    pairs = _fuzz_pairs(np.random.default_rng(5), 32, max_band=16)
    a, _ = run_stream(pairs, W=32)
    b, _ = run_stream(pairs, W=64)
    assert (a == b).all()


def test_shape_rules():
    assert width_for_band(1) == 32
    assert width_for_band(15) == 32  # 31 slots: one warp of lanes
    assert width_for_band(16) == 64
    assert width_for_band(60) == 128
    assert smax_for(0) == 16
    assert smax_for(90 + 106) == 208  # 90 bp read at band 15
    assert smax_for(14) == 16 and smax_for(15) == 32


def _mk_problems(rng, text, RPAD, NR, n, XMAX, YMAX, band_max=15):
    reads = np.zeros((NR, RPAD), np.uint8)
    for i in range(NR):
        p = int(rng.integers(0, len(text) - RPAD))
        r = text[p : p + RPAD].copy()
        for _ in range(int(rng.integers(0, 5))):
            r[int(rng.integers(0, RPAD))] = ord("ACGT"[int(rng.integers(0, 4))])
        reads[i] = r
    rows = []
    for _ in range(n):
        band = int(rng.integers(1, band_max + 1))
        xd = int(rng.integers(1, 40))
        xlen = int(rng.integers(1, XMAX + 1))
        ylen = int(rng.integers(1, YMAX + 1))
        ri = int(rng.integers(0, NR))
        q = int(rng.integers(0, RPAD - 1))
        xdir = 1 if rng.random() < 0.5 else -1
        xlen = min(xlen, RPAD - q) if xdir == 1 else min(xlen, q + 1)
        p = int(rng.integers(0, len(text)))
        ydir = 1 if rng.random() < 0.5 else -1
        ylen = max(min(ylen, len(text) - p if ydir == 1 else p + 1), 1)
        rows.append(meta_row(p, ydir, ylen, ri * RPAD + q, xdir, xlen, band, xd))
    return reads, np.asarray(rows, np.int32)


@pytest.mark.parametrize("seed", [31, 32])
def test_packed_meta_bit_identity(seed):
    """The 4-col packed meta upload form reproduces the 9-col form's
    output rows bit for bit through the production step."""
    rng = np.random.default_rng(seed)
    text = rng.choice(np.frombuffer(b"ACGT", np.uint8), 5000)
    words = pack_text_nib_host(text)
    lw = np.int32(nib_lw(len(text)))
    XMAX, YMAX = 64, 96
    reads, meta = _mk_problems(rng, text, 64, 32, 48, XMAX, YMAX)
    nib = pack_reads_nib_host(reads.reshape(-1))
    kern = get_stream_kernel(XMAX, YMAX, 32, smax_for(XMAX + YMAX))
    a = [np.asarray(v) for v in kern(words, lw, nib, meta)]
    b = [np.asarray(v) for v in kern(words, lw, nib, pack_meta_host(meta))]
    assert all((u == v).all() for u, v in zip(a, b))
    assert (a[0][:, 0] & 0xFFFF != 0).any()  # some nonzero scores


@pytest.fixture(scope="module")
def fixture_index(tmp_path_factory):
    from fixtures import write_fixture

    from thermite.index.build import Index

    ref, gtf, _ = write_fixture(tmp_path_factory.mktemp("sk"))
    return Index.create_from_files(ref, gtf)


def _opts():
    from thermite.align.driver import AlignOpts

    return AlignOpts(min_seed_len=3, min_aln_score=0, intron_mode=True)


def test_route_choice_on_cpu(fixture_index):
    from thermite.align.batch import BatchAligner

    ba = BatchAligner(fixture_index, _opts())
    assert ba.backend == "stream" and ba.native is not None and ba.can_emit()
    two = BatchAligner(fixture_index, _opts(), use_native=False)
    assert two.backend == "xla" and two.native is None and not two.can_emit()
    with pytest.raises(ValueError, match="needs the native engine"):
        BatchAligner(fixture_index, _opts(), backend="stream", use_native=False)
    with pytest.raises(ValueError, match="unknown backend"):
        BatchAligner(fixture_index, _opts(), backend="pallas")


def test_missing_native_engine_raises(fixture_index, monkeypatch):
    """The stream route never falls back silently when the native
    engine is missing; it raises and says why."""
    from thermite.align import native_batch
    from thermite.align.batch import BatchAligner

    def broken(*a, **k):
        raise RuntimeError("native library unavailable")

    monkeypatch.setattr(native_batch.NativeBatchEngine, "__init__", broken)
    with pytest.raises(RuntimeError, match="needs the native engine"):
        BatchAligner(fixture_index, _opts())
    # the two-pass test path may still run without it
    assert BatchAligner(fixture_index, _opts(), backend="xla").native is None


def test_window_wider_than_text_pad_raises():
    """Windows longer than the text padding would gather before the
    padded region: the step refuses them instead of reading garbage."""
    from thermite.ops.layout import _WPAD
    from thermite.ops.stream import make_stream_call

    make_stream_call(_WPAD, _WPAD, 32, 16)
    with pytest.raises(ValueError, match="exceeds the text padding"):
        make_stream_call(_WPAD + 32, 128, 32, 16)
    with pytest.raises(ValueError, match="exceeds the text padding"):
        make_stream_call(96, _WPAD + 32, 32, 16)


@pytest.mark.gpu
def test_card_matches_cpu_compilation(gpu_device):
    """On the card: the kernel as XLA compiles it for the GPU gives the
    CPU compilation's rows bit for bit, and they decode to the oracle's
    alignments."""
    import jax

    pairs = []
    for s in range(6):
        pairs += _fuzz_pairs(np.random.default_rng(200 + s), 64, max_band=16)
    XMAX, YMAX = 32, 64
    SMAX = smax_for(XMAX + YMAX)
    host = pack_pairs(pairs, XMAX, YMAX)
    f = jax.jit(lambda a, b, c: stream_rows(a, b, c, SMAX, 32))
    on_card = f(*(jax.device_put(v, gpu_device) for v in host))
    on_cpu = f(*(jax.device_put(v, jax.devices("cpu")[0]) for v in host))
    assert list(on_card[0].devices()) == [gpu_device]
    for u, v in zip(on_card, on_cpu):
        assert (np.asarray(u) == np.asarray(v)).all()
    rows = np.concatenate([np.asarray(v) for v in on_card], axis=1)
    p = host[2]
    for (xs, ys, b, d), got in zip(pairs, decode_stream_batch(rows, p[:, 0], p[:, 1])):
        assert got == SwgExtend(b).extend(xs, ys, b, d)
