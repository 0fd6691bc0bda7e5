"""Batched banded SWG extension — JAX kernel.

Computes, for a batch of (query flank x, reference flank y) pairs, the
same banded Smith-Waterman-Gotoh extension as the scalar oracle
(``thermite.ops.swg_ref``, semantics of reference src/swg.rs), fully
vectorized over the batch (the two-pass xla test path):

* the DP advances one *column* (one y base) per ``lax.scan`` step,
* each column updates all band slots of all pairs at once,
* the serial within-column insertion recurrence
  ``R[t] = max(R[t-1], D[t-1] + open) + extend`` is unrolled into an
  exclusive prefix-max:  with A[t] = max(diag, del) (the R-independent
  part of D) and unit gap costs,
  ``R[t] = open + t*extend + cummax_{k<t}(A[k] - k*extend)``,
  which is exact because D[t] = max(A[t], R[t]) and open <= 0.

Per-pair dynamic band width / X-drop are supported inside a single
static-shape batch via masking; the band slot layout, phase-1/phase-2
column anchoring, X-drop stop flags (global stop on phase-1 break, see
swg_ref's docstring for why), strict-greater max tracking and d>c>r
direction tie-breaks all match the oracle exactly on every reachable
cell (unreachable "junk" cells at ~MIN_SCORE may differ by a few units
of score, which cannot affect any traceback since real score chains
never mix with ~MIN_SCORE values — fuzzed in tests/test_swg_batch.py).

Outputs: per-pair max score, max cell (i, j), and the packed direction
matrix (B, YMAX+1, W) for host-side traceback.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..constants import GAP_EXTEND, GAP_OPEN, MATCH_SCORE, MIN_SCORE, MISMATCH_SCORE

# direction codes (match oracle ops order)
DIR_MATCH = 0
DIR_SUBST = 1
DIR_DEL = 2
DIR_INS = 3

_PAD = jnp.int32(-(1 << 31) + (1 << 21))  # prefix-scan pad; never wins


def make_swg_kernel(W: int, unroll: int = 4):
    """Build a jitted batched SWG kernel for static band-array width W."""

    e = jnp.int32(GAP_EXTEND)
    o = jnp.int32(GAP_OPEN)
    MIN = jnp.int32(MIN_SCORE)

    def kernel(x, xlen, y, ylen, band, x_drop):
        B, XMAX = x.shape
        YMAX = y.shape[1]
        t = jnp.arange(W, dtype=jnp.int32)[None, :]  # (1, W)
        b = band[:, None]  # (B, 1)

        # column 0: gap ladder on slots 1..2b, D[0]=C[0]=R[0]=0
        ladder = t * e + o
        D0 = jnp.where(t == 0, 0, jnp.where(t <= 2 * b, ladder, MIN))
        C0 = jnp.broadcast_to(jnp.where(t == 0, 0, MIN), (B, W))
        R0 = jnp.where(t == 0, 0, jnp.where(t <= 2 * b, ladder, MIN))
        dirs0 = jnp.where(t <= 2 * b, DIR_INS, DIR_MATCH).astype(jnp.uint8)

        def col(carry, j):
            D, C, R, win, max_s, max_i, max_j, stop1, stop2 = carry
            j = j.astype(jnp.int32)
            in_p1 = j <= band  # (B,)
            shift_b = ~in_p1  # (B,) bool: band slides this column
            col_in_range = j <= ylen
            active = col_in_range & ~stop1 & (in_p1 | ~stop2)

            row0 = jnp.maximum(j - band, 0)[:, None]  # (B,1)
            i_row = row0 + t  # (B, W)
            computed = (t <= 2 * b) & (i_row <= xlen[:, None])

            # Previous-column values at shifted slots.  The shift is 0
            # (phase 1) or 1 (phase 2) per pair, so shifted reads are a
            # static roll selected per row — no dynamic gather.
            sh = shift_b[:, None]
            D_l = jnp.concatenate([D[:, 1:], jnp.full((B, 1), MIN)], axis=1)
            C_l = jnp.concatenate([C[:, 1:], jnp.full((B, 1), MIN)], axis=1)
            D_r = jnp.concatenate([jnp.full((B, 1), MIN), D[:, :-1]], axis=1)
            Dp = jnp.where(sh, D_l, D)  # slot t+shift
            Cp = jnp.where(sh, C_l, C)
            Dm = jnp.where(sh, D, D_r)  # slot t+shift-1

            # Rolling window of x: win[t] = x[row0(j) + t - 1].  When the
            # band slides, pull in one new char per pair (a (B,1) gather).
            pull_idx = jnp.clip(row0 + W - 2, 0, XMAX - 1)
            pulled = jnp.take_along_axis(x, pull_idx, axis=1)  # (B,1)
            win_l = jnp.concatenate([win[:, 1:], pulled], axis=1)
            win = jnp.where(sh, win_l, win)

            # deletion (gap in x, consumes y)
            c_val = jnp.maximum(Cp + e, Dp + e + o)
            # reference src/swg.rs:123: band_idx == w-1 in phase 2 -> MIN
            c_val = jnp.where(sh & (t == 2 * b), MIN, c_val)

            # diagonal
            yj = jax.lax.dynamic_slice_in_dim(
                y, jnp.clip(j - 1, 0, YMAX - 1), 1, axis=1
            )  # (B,1)
            is_match = (i_row > 0) & (win == yj)
            s = jnp.where(is_match, MATCH_SCORE, MISMATCH_SCORE).astype(jnp.int32)
            d_val = jnp.where(i_row == 0, MIN, Dm + s)

            # insertion via exclusive prefix-max (see module docstring)
            A = jnp.maximum(d_val, c_val)
            A_m = jnp.where(computed, A, MIN)
            base = A_m - t * e
            cm = jax.lax.cummax(
                jnp.concatenate([jnp.full((B, 1), _PAD), base[:, :-1]], axis=1),
                axis=1,
            )
            r_val = jnp.where(t == 0, MIN, o + t * e + cm)

            D_new = jnp.maximum(A, r_val)
            dir_new = jnp.where(
                D_new == d_val,
                jnp.where(is_match, DIR_MATCH, DIR_SUBST),
                jnp.where(D_new == c_val, DIR_DEL, DIR_INS),
            ).astype(jnp.uint8)

            # In-place oracle semantics: slots not computed this column
            # keep their previous values... but when the band slid (sh),
            # the previous value for slot t is the pre-shift slot t
            # content, matching the oracle's unshifted in-place arrays.
            mask = computed & active[:, None]
            D_out = jnp.where(mask, D_new, D)
            C_out = jnp.where(mask, c_val, C)
            R_out = jnp.where(mask, r_val, R)
            dirs_row = jnp.where(mask, dir_new, jnp.uint8(DIR_MATCH))

            D_for_max = jnp.where(mask, D_new, MIN)
            band_max = jnp.max(D_for_max, axis=1)
            col_arg = jnp.argmax(D_for_max, axis=1).astype(jnp.int32)
            improved = active & (band_max > max_s)
            max_s = jnp.where(improved, band_max, max_s)
            max_i = jnp.where(improved, row0[:, 0] + col_arg, max_i)
            max_j = jnp.where(improved, j, max_j)

            dropped = band_max < max_s - x_drop
            stop1 = jnp.where(in_p1 & active, stop1 | dropped, stop1)
            stop2 = jnp.where(~in_p1 & active, stop2 | dropped, stop2)

            return (
                D_out, C_out, R_out, win, max_s, max_i, max_j, stop1, stop2
            ), dirs_row

        # initial x window for column 1 (row0 = 0): win[t] = x[t-1]
        win0 = jnp.pad(x, ((0, 0), (1, max(0, W - 1 - XMAX))))[:, :W]

        zeros = jnp.zeros((B,), jnp.int32)
        init = (
            D0.astype(jnp.int32),
            C0.astype(jnp.int32),
            R0.astype(jnp.int32),
            win0,
            zeros,
            zeros,
            zeros,
            jnp.zeros((B,), bool),
            jnp.zeros((B,), bool),
        )
        carry, dirs_cols = jax.lax.scan(
            col, init, jnp.arange(1, YMAX + 1), unroll=unroll
        )
        _, _, _, _, max_s, max_i, max_j, _, _ = carry
        dirs = jnp.concatenate(
            [dirs0[:, None, :], jnp.moveaxis(dirs_cols, 0, 1)], axis=1
        )
        return max_s, max_i, max_j, dirs

    return jax.jit(kernel)


_KERNEL_CACHE = {}


def get_swg_kernel(W: int, unroll: int = 4):
    key = (W, unroll)
    if key not in _KERNEL_CACHE:
        _KERNEL_CACHE[key] = make_swg_kernel(W, unroll)
    return _KERNEL_CACHE[key]


def gather_windows_bytes(ref_text, reads, meta, XMAX, YMAX):
    """ASCII-byte window builder for this test backend: the y byte base
    is reconstructed from the (word, sub) anchor in int32 arithmetic, so
    this path serves sub-2-GiB texts only."""
    from .layout import _WPAD

    G = ref_text.shape[0]
    R = reads.size
    reads_flat = reads.reshape(-1)

    ix = jnp.arange(XMAX, dtype=jnp.int32)[None, :]
    xi = meta[:, 4:5] + meta[:, 5:6] * ix
    xv = ix < meta[:, 6:7]
    x = jnp.where(xv, jnp.take(reads_flat, jnp.clip(xi, 0, R - 1)), 0).astype(
        jnp.uint8
    )

    ybase = 8 * meta[:, 0:1] + meta[:, 1:2] - _WPAD
    iy = jnp.arange(YMAX, dtype=jnp.int32)[None, :]
    yi = ybase + meta[:, 2:3] * iy
    yv = iy < meta[:, 3:4]
    y = jnp.where(yv, jnp.take(ref_text, jnp.clip(yi, 0, G - 1)), 0).astype(
        jnp.uint8
    )
    return x, y


def swg_gather_call(XMAX: int, YMAX: int, W: int, unroll: int = 4):
    """Unjitted gather+DP step over a resident reference text (meta
    layout = ``layout.META_COLS``).  Shared by the jitted single-device
    wrapper below and the sharded step in ``parallel/mesh.py`` (one
    definition of the meta column mapping)."""
    inner = make_swg_kernel(W, unroll)

    def call(ref_text, reads, meta):
        x, y = gather_windows_bytes(ref_text, reads, meta, XMAX, YMAX)
        return inner(x, meta[:, 6], y, meta[:, 3], meta[:, 7], meta[:, 8])

    return call


def make_swg_gather_kernel(XMAX: int, YMAX: int, W: int, unroll: int = 4):
    """Jitted single-device gather front-end (xla test backend)."""
    return jax.jit(swg_gather_call(XMAX, YMAX, W, unroll))


_GATHER_CACHE = {}


def get_swg_gather_kernel(XMAX: int, YMAX: int, W: int, unroll: int = 4):
    key = (XMAX, YMAX, W, unroll)
    if key not in _GATHER_CACHE:
        _GATHER_CACHE[key] = make_swg_gather_kernel(XMAX, YMAX, W, unroll)
    return _GATHER_CACHE[key]
