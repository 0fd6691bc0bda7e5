"""Multi-device data-parallel tests on the virtual 8-device CPU mesh."""

import numpy as np
import jax

from thermite.parallel.mesh import dp_align_step, make_mesh


def test_eight_device_mesh_forward():
    assert len(jax.devices()) == 8, "conftest should force 8 CPU devices"
    mesh = make_mesh(8)
    step = dp_align_step(mesh, W=128)
    B = 64
    rng = np.random.default_rng(0)
    x = rng.integers(65, 85, (B, 32)).astype(np.uint8)
    y = np.concatenate([x, x[:, :16]], axis=1)
    xlen = np.full(B, 32, np.int32)
    ylen = np.full(B, 48, np.int32)
    band = np.full(B, 8, np.int32)
    xd = np.full(B, 8, np.int32)
    score, mi, mj, n_pass = step(x, xlen, y, ylen, band, xd, np.int32(31))
    # y starts with x itself: every problem scores a full match of 32
    assert (np.asarray(score) == 32).all()
    assert int(n_pass) == B

    # sharded result must equal the single-device kernel
    mesh1 = make_mesh(1)
    step1 = dp_align_step(mesh1, W=128)
    s1, m1, mj1, np1 = step1(x, xlen, y, ylen, band, xd, np.int32(31))
    assert (np.asarray(score) == np.asarray(s1)).all()
    assert (np.asarray(mi) == np.asarray(m1)).all()
    assert int(n_pass) == int(np1)


def test_graft_entry():
    import sys

    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    ge.dryrun_multichip(8)


def test_dp_gather_align_step_matches_unsharded():
    """Production layout (replicated text, sharded offset problems,
    on-device gather) must match the single-device gather kernel."""
    from thermite.ops.swg_batch import get_swg_gather_kernel
    from thermite.parallel.mesh import dp_gather_align_step, make_mesh

    rng = np.random.default_rng(3)
    ref_text = rng.integers(65, 69, 2048).astype(np.uint8)
    B, RPAD = 16, 32
    reads = np.zeros((B, RPAD), np.uint8)
    meta = np.zeros((2 * B, 9), np.int32)
    from thermite.ops.layout import meta_row

    for i in range(B):
        p = int(rng.integers(4, len(ref_text) - RPAD - 4))
        r = ref_text[p : p + RPAD].copy()
        r[int(rng.integers(0, RPAD))] = 65 + int(rng.integers(0, 4))
        reads[i] = r
        meta[2 * i] = meta_row(p + 4, 1, 40, i * RPAD + 4, 1, RPAD - 4, 8, 8)
        meta[2 * i + 1] = meta_row(p + 3, -1, 12, i * RPAD + 3, -1, 4, 8, 8)

    mesh = make_mesh(8)
    step = dp_gather_align_step(mesh, XMAX=32, YMAX=64, W=128)
    score, mi, mj, n_pass = step(ref_text, reads, meta, np.int32(20))

    kern = get_swg_gather_kernel(32, 64, 128)
    s1, m1, j1, _ = kern(ref_text, reads, meta)
    assert (np.asarray(score) == np.asarray(s1)).all()
    assert (np.asarray(mi) == np.asarray(m1)).all()
    assert (np.asarray(mj) == np.asarray(j1)).all()
    assert int(n_pass) == int((np.asarray(s1) >= 20).sum())
