"""Differential tests: batched JAX SWG kernel vs the scalar oracle.

Random (x, y, band, x_drop) pairs, including adversarial cases that
exercise X-drop early termination, bands wider than sequences, and
per-pair band diversity inside one batch.
"""

import numpy as np
import pytest

from thermite.ops.swg_batch import get_swg_kernel
from thermite.ops.swg_ref import SwgExtend
from thermite.ops.traceback import traceback_batch


def run_batch(pairs, W=None, XMAX=None, YMAX=None):
    """pairs: list of (x: bytes, y: bytes, band: int, x_drop: int)."""
    B = len(pairs)
    bmax = max(p[2] for p in pairs)
    W = W or (2 * bmax + 1)
    XMAX = XMAX or max(len(p[0]) for p in pairs)
    YMAX = YMAX or max(len(p[1]) for p in pairs)
    x = np.zeros((B, max(XMAX, 1)), np.uint8)
    y = np.zeros((B, max(YMAX, 1)), np.uint8)
    xlen = np.zeros(B, np.int32)
    ylen = np.zeros(B, np.int32)
    band = np.zeros(B, np.int32)
    xd = np.zeros(B, np.int32)
    for k, (xs, ys, b, d) in enumerate(pairs):
        x[k, : len(xs)] = np.frombuffer(xs, np.uint8)
        y[k, : len(ys)] = np.frombuffer(ys, np.uint8)
        xlen[k], ylen[k], band[k], xd[k] = len(xs), len(ys), b, d
    kern = get_swg_kernel(W, unroll=2)
    score, mi, mj, dirs = (np.asarray(v) for v in kern(x, xlen, y, ylen, band, xd))
    return traceback_batch(dirs, band, mi, mj, xlen, ylen, score)


def assert_matches_oracle(pairs):
    got = run_batch(pairs)
    for (xs, ys, b, d), g in zip(pairs, got):
        want = SwgExtend(b).extend(xs, ys, b, d)
        assert g == want, f"x={xs!r} y={ys!r} band={b} xdrop={d}\n got={g}\nwant={want}"


def test_reference_cases():
    assert_matches_oracle(
        [
            (b"AAAAAAAA", b"AAAAAAAA", 1, 1),
            (b"AAAAATTT", b"AAAAAAAA", 1, 1),
            (b"AAATAAAA", b"AAAAAAAA", 1, 1),
            (b"AAATTTT", b"AAACCTTTT", 2, 3),
        ]
    )


def test_mixed_bands_one_batch():
    assert_matches_oracle(
        [
            (b"ACGTACGT", b"ACGTACGT", 1, 1),
            (b"ACGTACGT", b"ACGGTACGT", 4, 8),
            (b"ACGT", b"TTTTTTTT", 2, 2),
            (b"A", b"A", 1, 1),
            (b"ACGTACGTACGT", b"ACG", 3, 3),
        ]
    )


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_vs_oracle(seed):
    rng = np.random.default_rng(seed)
    alpha = b"ACGT"
    pairs = []
    for _ in range(64):
        xl = int(rng.integers(1, 40))
        yl = int(rng.integers(1, 60))
        if rng.random() < 0.6:
            # correlated: y = x with indels/substitutions
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
        b = int(rng.integers(1, 12))
        d = int(rng.integers(0, 15))
        pairs.append((xs, ys, b, d))
    assert_matches_oracle(pairs)


def test_tight_xdrop_termination():
    # x_drop=0 terminates aggressively; batch must freeze identically.
    assert_matches_oracle(
        [
            (b"AAAATTTTAAAA", b"AAAACCCCAAAA", 3, 0),
            (b"AAAATTTTAAAA", b"AAAACCCCAAAA", 3, 1),
            (b"TTTTTTTT", b"CCCCCCCC", 2, 0),
            (b"ACACACAC", b"ACACTTACAC", 5, 2),
        ]
    )
