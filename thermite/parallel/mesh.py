"""Device mesh / sharding for data-parallel read alignment.

The workload is embarrassingly parallel over reads with read-only
shared state (the reference's whole concurrency story is cloning
aligners across threads over an Arc'd index, reference
src/wrapper.rs:20-27).  The device mapping is therefore pure data
parallelism: extension problems shard along a 1-D ``data`` mesh axis
over the local devices, the genome/index arrays are replicated in
every device's memory, and per-read outputs come back sharded; global
statistics (mapped counts, score histograms) reduce with ``psum``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

try:  # moved out of experimental in jax 0.8 (check_rep -> check_vma)
    from jax import shard_map as _shard_map

    def shard_map(f, **kw):
        return _shard_map(f, check_vma=False, **kw)
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map as _shard_map

    def shard_map(f, **kw):
        return _shard_map(f, check_rep=False, **kw)


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    # local_devices, not devices: after jax.distributed.initialize a
    # host only ADDRESSES its own chips — global devices of other hosts
    # cannot back a local mesh (the CLI promises "N local devices")
    devices = jax.local_devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"requested a {n_devices}-device mesh but only "
                f"{len(devices)} local device(s) are available"
            )
        devices = devices[:n_devices]
    return Mesh(np.array(devices), ("data",))


def sharded_forward_scores(mesh: Mesh, W: int, unroll: int = 4):
    """Batched SWG forward sharded over the ``data`` axis.

    Inputs shard on dim 0 (one shard of extension problems per chip);
    the kernel needs no cross-problem communication, so XLA runs it
    fully parallel.  Also returns a psum'd global count of problems
    whose score clears a threshold — the collective that production
    stats aggregation rides on.
    """
    from ..ops.swg_batch import make_swg_kernel

    kern = make_swg_kernel(W, unroll)

    def step(x, xlen, y, ylen, band, x_drop, min_score):
        score, mi, mj, _dirs = kern(x, xlen, y, ylen, band, x_drop)
        n_pass = jnp.sum((score >= min_score).astype(jnp.int32))
        return score, mi, mj, n_pass

    data_sharding = NamedSharding(mesh, P("data"))
    repl = NamedSharding(mesh, P())
    return jax.jit(
        step,
        in_shardings=(
            data_sharding, data_sharding, data_sharding,
            data_sharding, data_sharding, data_sharding, repl,
        ),
        out_shardings=(data_sharding, data_sharding, data_sharding, repl),
    )


def dp_align_step(mesh: Mesh, W: int):
    """Multi-chip alignment step on materialised windows: shard
    problems, run the DP, reduce global stats."""
    return sharded_forward_scores(mesh, W)


def sharded_stream_kernel(mesh: Mesh, XMAX: int, YMAX: int, W: int, SMAX: int):
    """The per-chunk stream step (window gathers + stream kernel +
    header epilogue, ops/stream.py) sharded along ``data``: reference
    text and read block replicated on every device, problem meta sharded
    on rows, per-device gather + DP + walk, outputs (hdr (N, 2),
    streams (N, SMAX/16)) row-sharded.  This is what
    ``BatchAligner(mesh=...)`` dispatches — the device equivalent of the
    reference's clone-across-threads concurrency (reference
    src/wrapper.rs:20-27).  Row count must divide by the mesh size
    (callers pad)."""
    from ..ops.stream import make_stream_call

    f = shard_map(
        make_stream_call(XMAX, YMAX, W, SMAX),
        mesh=mesh,
        in_specs=(P(), P(), P(), P("data")),
        out_specs=(P("data"), P("data")),
    )
    return jax.jit(f)


def sharded_swg_gather_kernel(mesh: Mesh, XMAX: int, YMAX: int, W: int):
    """The XLA (CPU-test) gather+forward kernel sharded along ``data``
    — same layout as ``sharded_stream_kernel`` for the two-pass
    backend, so the full batch pipeline runs under a mesh in tests."""
    from ..ops.swg_batch import swg_gather_call

    call = swg_gather_call(XMAX, YMAX, W)
    f = shard_map(
        call,
        mesh=mesh,
        in_specs=(P(), P(), P("data")),
        out_specs=(P("data"), P("data"), P("data"), P("data")),
    )
    return jax.jit(f)


def dp_gather_align_step(mesh: Mesh, XMAX: int, YMAX: int, W: int, unroll: int = 2):
    """The production multi-chip layout: the reference text and the read
    block are REPLICATED in every chip's HBM, extension problems (8-int32
    gather offsets) are SHARDED along ``data``, each chip gathers its own
    x/y windows locally and runs the banded DP, and global stats reduce
    with a psum.  This is the full sharding story of the batch
    pipeline (align/batch.py) expressed as one pjit-able step; the driver
    dry-runs it on an N-device mesh to validate the layout compiles and
    executes.

    step(ref_text (G,) u8, reads (B, RPAD) u8, meta (N, 9) i32,
         min_score) -> (score, max_i, max_j sharded; n_pass replicated)
    """
    from ..ops.swg_batch import swg_gather_call

    inner = swg_gather_call(XMAX, YMAX, W, unroll)

    def step(ref_text, reads, meta, min_score):
        score, mi, mj, _dirs = inner(ref_text, reads, meta)
        n_pass = jnp.sum((score >= min_score).astype(jnp.int32))
        return score, mi, mj, n_pass

    data = NamedSharding(mesh, P("data"))
    repl = NamedSharding(mesh, P())
    return jax.jit(
        step,
        in_shardings=(repl, repl, data, repl),
        out_shardings=(data, data, data, repl),
    )
