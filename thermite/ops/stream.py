"""The single-pass stream kernel: banded SWG forward pass, band-exactness
certificate and traceback walk, emitting one packed op stream per
extension problem.

Semantics are those of the scalar oracle (``ops/swg_ref.py``, reference
src/swg.rs:31-240).  The kernel is plain ``jax.numpy``/``lax``, compiled
by XLA for the CPU and the GPU alike.  (A hand-fused CUDA form, one warp
per problem, measured 10x faster alone but no faster end to end, where
the host stages hide the device step; PERF.md keeps that finding.)

Outputs per problem: ``meta4`` = [score, max_i, max_j, nsteps] and
``streams`` = SMAX/16 int32 words of 2-bit DIR codes in *backward* walk
order, 16 per word, little-endian.  nsteps = -1 flags an unterminated
walk (host recomputes; not observed in practice).

**Band-exactness certificate** (nsteps = -2 - steps on failure): the
kernel also proves, per problem, that running the SAME problem at ANY
wider band (larger ``band``, ylen re-clamped accordingly, same x_drop)
would produce a bit-identical output row.  This powers the adaptive
narrow-band pass: the host submits problems at a narrow band and
recomputes only certificate failures at full band (C++ oracle).

Soundness sketch (constants M/o/e = MATCH/GAP_OPEN/GAP_EXTEND): any path
that touches a cell outside the narrow band must contain at least
band+1 gap extensions and one open, so its score prefix at column j is
bounded by E(j) = min(j, xlen)*M + o + (band+1)*e.  The certificate
requires

  (a) every pre-stop column's band max exceeds E(j) - x_drop (tracked
      as ``cmin``): the wide DP can then never X-drop-stop earlier than
      the narrow one (in-band values only grow with band;
      excursion-inflated running maxima are offset by (a)),
  (b) final max_s strictly exceeds E(j_stop) + x_drop if the narrow
      pass stopped (the wide pass then stops at the same column, and no
      excursion value can beat or tie max_s), or strictly exceeds
      E(ylen) if it ran to completion,

so the wide optimum, its first-attainment cell (max_i, max_j), and every
traceback direction along the walk coincide with the narrow pass's.

Layout: band slot t of column j holds row i = max(j - band, 0) + t; the
band slides one row per column once j > band (phase 2).  The
within-column insertion chain is an exclusive prefix max over slots.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..constants import GAP_EXTEND, GAP_OPEN, MATCH_SCORE, MIN_SCORE, MISMATCH_SCORE
from .layout import (
    DIR_DEL,
    DIR_INS,
    DIR_MATCH,
    DIR_SUBST,
    check_window,
    gather_windows,
    meta9,
    pack_stream_hdr,
    params_from_meta,
)

_PAD = -(1 << 31) + (1 << 21)  # prefix-scan pad; never wins


def _round_up(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


def width_for_band(bmax: int) -> int:
    """Band-slot width of the kernel: 2*bmax+1 slots rounded up to 32
    (32 serves the narrow band of 15)."""
    return max(_round_up(2 * bmax + 1, 32), 32)


def smax_for(max_xy: int) -> int:
    """Walk step capacity for problems with xlen + ylen <= max_xy."""
    return _round_up(max_xy + 2, 16)


def stream_rows(x, y, params, SMAX: int, W: int):
    """The stream kernel.

    x (N, XMAX) uint8 codes (0 beyond xlen), y (N, YMAX) uint8 codes,
    params (N, 4) int32 [xlen, ylen, band, x_drop] with 2*band+1 <= W.
    Returns (meta4 (N, 4) int32, streams (N, SMAX // 16) int32).

    Both loops have static trip counts (every column up to YMAX, SMAX
    walk steps): columns past a problem's end and steps past its walk
    are masked no-ops, so the result does not depend on the bound."""
    assert SMAX % 16 == 0
    N, XMAX = x.shape
    YMAX = y.shape[1]
    e = jnp.int32(GAP_EXTEND)
    o = jnp.int32(GAP_OPEN)
    MIN = jnp.int32(MIN_SCORE)
    M = jnp.int32(MATCH_SCORE)
    xlen, ylen, band, x_drop = (params[:, k : k + 1] for k in range(4))
    t = jnp.arange(W, dtype=jnp.int32)[None, :]
    tz = t == 0
    te = t * e
    b2 = 2 * band

    D = jnp.where(tz, 0, jnp.where(t <= b2, te + o, MIN))
    C = jnp.broadcast_to(jnp.where(tz, 0, MIN), (N, W))
    # x source: xsrc[k] = x[k-1], so window slot t of column j reads
    # xsrc[row0 + t] with row0 = max(j - band, 0)
    xsrc = jnp.pad(x.astype(jnp.int32), ((0, 0), (1, W)))
    win = xsrc[:, :W]
    yT = y.T.astype(jnp.int32)  # (YMAX, N): column j-1 is a row
    dirs = jnp.zeros((YMAX + 1, N, W), jnp.int8)
    dirs = dirs.at[0].set(jnp.where(t <= b2, DIR_INS, DIR_MATCH).astype(jnp.int8))

    e_ladder = o + (band + 1) * e
    ub_final = xlen * M + e_ladder
    z = jnp.zeros((N, 1), jnp.int32)
    minc = jnp.full((N, W), MIN)
    padc = jnp.full((N, W), jnp.int32(_PAD))

    def column(j, carry):
        D, C, win, ms, mi, mj, s1, s2, cmin, ecap, rstop, dirs = carry
        in_p1 = j <= band
        sh = ~in_p1
        active = (j <= ylen) & (s1 == 0) & (in_p1 | (s2 == 0))
        row0 = jnp.maximum(j - band, 0)
        computed = (t <= b2) & (t <= xlen - row0)

        # previous-column reads at slots t+1 (phase 2) and t-1 (phase 1)
        D_l = jnp.concatenate([D[:, 1:], minc[:, :1]], axis=1)
        C_l = jnp.concatenate([C[:, 1:], minc[:, :1]], axis=1)
        D_r = jnp.concatenate([minc[:, :1], D[:, :-1]], axis=1)
        Dp = jnp.where(sh, D_l, D)
        Cp = jnp.where(sh, C_l, C)
        Dm = jnp.where(sh, D, D_r)

        # slide the x window one row and pull in xsrc[row0 + W - 1]
        pulled = jnp.take_along_axis(
            xsrc, jnp.minimum(row0 + (W - 1), XMAX + W), axis=1
        )
        win = jnp.where(sh, jnp.concatenate([win[:, 1:], pulled], axis=1), win)
        yj = jax.lax.dynamic_index_in_dim(yT, j - 1, axis=0, keepdims=False)

        c_val = jnp.maximum(Cp + e, Dp + e + o)
        c_val = jnp.where(sh & (t == b2), MIN, c_val)
        row_is0 = tz & in_p1
        is_match = (win == yj[:, None]) & ~row_is0
        s = jnp.where(is_match, MATCH_SCORE, MISMATCH_SCORE).astype(jnp.int32)
        d_val = jnp.where(row_is0, MIN, Dm + s)
        A = jnp.maximum(d_val, c_val)

        # exclusive prefix max of (A - t*e) over slots (log2 W steps)
        pm = jnp.concatenate(
            [padc[:, :1], (jnp.where(computed, A, MIN) - te)[:, :-1]], axis=1
        )
        k = 1
        while k < W:
            pm = jnp.maximum(
                pm, jnp.concatenate([padc[:, :k], pm[:, :-k]], axis=1)
            )
            k *= 2
        r_val = jnp.where(tz, MIN, o + te + pm)
        D_new = jnp.maximum(A, r_val)

        mask = computed & active
        D = jnp.where(mask, D_new, D)
        C = jnp.where(mask, c_val, C)
        dir_new = jnp.where(
            D_new == d_val,
            jnp.where(is_match, DIR_MATCH, DIR_SUBST),
            jnp.where(D_new == c_val, DIR_DEL, DIR_INS),
        )
        dirs = jax.lax.dynamic_update_index_in_dim(
            dirs, jnp.where(mask, dir_new, DIR_MATCH).astype(jnp.int8), j, 0
        )

        D_for_max = jnp.where(mask, D_new, MIN)
        bmax = jnp.max(D_for_max, axis=1, keepdims=True)
        col_arg = jnp.min(
            jnp.where(D_for_max == bmax, t, W), axis=1, keepdims=True
        )
        improved = active & (bmax > ms)
        ms = jnp.where(improved, bmax, ms)
        mi = jnp.where(improved, row0 + col_arg, mi)
        mj = jnp.where(improved, j, mj)

        dropped = bmax < ms - x_drop
        s1 = s1 | (in_p1 & active & dropped).astype(jnp.int32)
        s2 = s2 | (sh & active & dropped).astype(jnp.int32)
        ej = jnp.minimum(j, xlen) * M + e_ladder
        cmin = jnp.where(active & ~dropped, jnp.minimum(cmin, bmax - ej), cmin)
        # a REAL x-drop stop (computed cells fell x_drop below the
        # running max) forces the stronger stopped-case certificate;
        # band exhaustion (no in-band cells left, bmax == MIN) is
        # completion
        real_drop = active & dropped & (bmax > MIN)
        ecap = jnp.where(real_drop, ej, ecap)
        rstop = rstop | real_drop.astype(jnp.int32)
        return D, C, win, ms, mi, mj, s1, s2, cmin, ecap, rstop, dirs

    carry = jax.lax.fori_loop(
        1, YMAX + 1, column,
        (D, C, win, z, z, z, z, z, jnp.full((N, 1), 1 << 30, jnp.int32),
         jnp.broadcast_to(ub_final, (N, 1)), z, dirs),
    )
    ms, mi, mj, cmin, ecap, rstop, dirs = (carry[k] for k in (3, 4, 5, 8, 9, 10, 11))
    cert_ub = jnp.where(rstop > 0, ecap + x_drop, ub_final)
    cert = (cmin > -x_drop) & (ms > cert_ub)

    # traceback walk: each problem steps back from its max cell once
    # per iteration, so step c of every live walk lands in code slot c;
    # 16 steps fill one packed word
    rows = jnp.arange(N, dtype=jnp.int32)
    bandv = band[:, 0]

    def word(w, st):
        i, j, c, out = st
        acc = jnp.zeros((N,), jnp.uint32)
        for k in range(16):
            alive = (i > 0) | (j > 0)
            bi = jnp.clip(i - jnp.maximum(j - bandv, 0), 0, 2 * bandv)
            d = jnp.where(alive, dirs[j, rows, bi].astype(jnp.int32), 0)
            acc = acc | (d.astype(jnp.uint32) << (2 * k))
            i = i - (alive & ((d <= DIR_SUBST) | (d == DIR_INS)))
            j = j - (alive & ((d <= DIR_SUBST) | (d == DIR_DEL)))
            c = c + alive
        out = jax.lax.dynamic_update_index_in_dim(
            out, jax.lax.bitcast_convert_type(acc, jnp.int32), w, 0
        )
        return i, j, c, out

    PW = SMAX // 16
    i, j, c, out = jax.lax.fori_loop(
        0, PW, word,
        (mi[:, 0], mj[:, 0], jnp.zeros((N,), jnp.int32),
         jnp.zeros((PW, N), jnp.int32)),
    )
    bad = (i > 0) | (j > 0)
    nsteps = jnp.where(bad, -1, jnp.where(cert[:, 0], c, -2 - c))
    meta4 = jnp.concatenate([ms, mi, mj, nsteps[:, None]], axis=1)
    return meta4, out.T


def make_stream_call(XMAX: int, YMAX: int, W: int, SMAX: int):
    """UNJITTED fn(ref_nib, ref_lw, reads_nib, meta) -> (hdr (N, 2),
    streams (N, SMAX/16)): the production per-chunk device step — window
    gathers, the stream kernel, and the packed header epilogue.  Callers
    jit it (one device) or wrap it in shard_map (parallel/mesh.py)."""
    check_window(XMAX, YMAX)

    def call(ref_nib, ref_lw, reads_nib, meta):
        meta = meta9(meta)
        x, y = gather_windows(ref_nib, ref_lw, reads_nib, meta, XMAX, YMAX)
        meta4, streams = stream_rows(x, y, params_from_meta(meta), SMAX, W)
        return pack_stream_hdr(meta4), streams

    return call


_CACHE = {}


def get_stream_kernel(XMAX, YMAX, W, SMAX):
    key = (XMAX, YMAX, W, SMAX)
    if key not in _CACHE:
        _CACHE[key] = jax.jit(make_stream_call(XMAX, YMAX, W, SMAX))
    return _CACHE[key]
