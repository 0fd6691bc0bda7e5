#!/usr/bin/env python3
"""Smoke run of the production alignment path on an NVIDIA GPU.

    python chip_smoke.py              # one card: every phase below
    python chip_smoke.py --cards 4    # four cards: the --mesh 4 path only

One process holds the card(s) for the whole run: the CLI is driven in
process through ``thermite.cli.main``, never as a child process.

Phases (one card):
  device  the card's name and power limit, JAX devices and version, the
          compile cache; fails unless JAX's platform is ``gpu``
  build   builds and loads the native (C++) engine
  kernel  compiles the stream kernel for the card at the production
          chunk shape (65,536 rows, XMAX 96, YMAX 128, band 15),
          requires every row bit-identical to its CPU compilation and
          sampled rows (certificate failures included) equal to the
          scalar oracle, times it, and runs the ``gpu``-marked tests
  e2e     500k 90 bp reads on the 45 Mbp synthetic chromosome through
          ``thermite align -a -k20 -s0 --intron-mode`` to BAM; the BAM
          must equal ``--engine cpp`` on every read and ``--engine
          oracle`` on the first 1,000; plus a paired-end run and a
          ``-s0.66`` run, each against ``--engine cpp``

Four cards: the same 500k-read run with ``--mesh 4`` against a one-card
run made in this process, with per-card reads/s, after checking that the
text and read block replicate to every card and problems shard over all.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Any failure exits non-zero before printing it.
"""

import argparse
import gzip
import json
import os
import statistics
import struct
import subprocess
import sys
import time

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "out")
SMOKE_DIR = os.path.join(OUT_DIR, "chip_smoke")
N_READS = 500_000
ROWS, XMAX, YMAX, BAND = 65_536, 96, 128, 15


def log(*a):
    print(*a, flush=True)


def card_label() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def bam_records(path):
    """(header bytes, [(read name, record bytes)]) of a BAM file."""
    raw = gzip.decompress(open(path, "rb").read())
    assert raw[:4] == b"BAM\x01", path
    (l_text,) = struct.unpack_from("<i", raw, 4)
    off = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", raw, off)
    off += 4
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", raw, off)
        off += 8 + l_name
    header, recs = raw[:off], []
    while off < len(raw):
        (bs,) = struct.unpack_from("<i", raw, off)
        l_rn = raw[off + 12]
        recs.append((raw[off + 36 : off + 36 + l_rn - 1], raw[off : off + 4 + bs]))
        off += 4 + bs
    return header, recs


def same_bam(a, b, what):
    ha, ra = bam_records(a)
    hb, rb = bam_records(b)
    if ha != hb or ra != rb:
        bad = next((i for i, (u, v) in enumerate(zip(ra, rb)) if u != v), min(len(ra), len(rb)))
        raise AssertionError(
            f"{what}: BAMs differ (headers equal: {ha == hb}; records "
            f"{len(ra)} vs {len(rb)}; first difference at record {bad})"
        )
    return len(ra)


def align(args, label):
    from thermite.cli import main as cli_main

    t0 = time.perf_counter()
    rc = cli_main(["align"] + args)
    dt = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"{label}: thermite align exited {rc}")
    return dt


def phase_device():
    import jax

    from thermite.cli import enable_compile_cache

    card = card_label()
    log(f"card: {card}")
    devs = jax.devices()
    log(f"jax {jax.__version__}; devices: {devs}")
    log(f"compile cache: {enable_compile_cache()}")
    if devs[0].platform != "gpu":
        raise RuntimeError(f"no GPU: JAX's platform is {devs[0].platform!r}")
    return card, devs


def phase_build():
    from thermite.seed import native

    t0 = time.perf_counter()
    if native._try_load() is None:
        raise RuntimeError(f"native engine missing: {native.load_error}")
    log(f"build: native engine ready in {time.perf_counter() - t0:.1f} s")


def phase_kernel(card):
    import jax
    import numpy as np

    from thermite.ops.runs import decode_stream_batch
    from thermite.ops.stream import smax_for, stream_rows, width_for_band
    from thermite.ops.swg_ref import SwgExtend
    from thermite.testing.synth import stream_problems

    SMAX = smax_for(90 + 90 + BAND + 1)
    host = stream_problems(ROWS, XMAX, YMAX, BAND, seed=11)
    x, y, params = host
    f = jax.jit(lambda a, b, c: stream_rows(a, b, c, SMAX, width_for_band(BAND)))
    gpu = [jax.device_put(v, jax.devices()[0]) for v in host]
    t0 = time.perf_counter()
    compiled = f.lower(*gpu).compile()
    log(f"kernel: compile for the card {time.perf_counter() - t0:.2f} s; "
        f"memory_analysis: {compiled.memory_analysis()}")
    on_card = [np.asarray(v) for v in compiled(*gpu)]
    if compiled(*gpu)[0].devices() != {jax.devices()[0]}:
        raise AssertionError("the stream kernel did not run on the card")
    cpu = [jax.device_put(v, jax.devices("cpu")[0]) for v in host]
    on_cpu = [np.asarray(v) for v in f(*cpu)]
    for u, v in zip(on_card, on_cpu):
        if not (u == v).all():
            bad = np.flatnonzero((u != v).reshape(len(u), -1).any(axis=1))
            raise AssertionError(
                f"card and CPU compilations differ on {len(bad)} rows, first "
                f"{bad[:5].tolist()}: params {params[bad[0]].tolist()}"
            )
    meta4 = on_card[0]
    ns = meta4[:, 3]
    log(f"kernel: {ROWS} rows x (XMAX {XMAX}, YMAX {YMAX}, band <= {BAND}, SMAX {SMAX}): "
        f"card == CPU compilation on every row; certificate failures "
        f"{int((ns <= -2).sum())}, flagged walks {int((ns == -1).sum())}")
    if (ns == -1).any():
        raise AssertionError("unterminated walks at production shapes")

    rng = np.random.default_rng(5)
    fails = np.flatnonzero(ns <= -2)
    pick = np.concatenate([fails[:300], rng.choice(ROWS, 1700, replace=False)])
    rows = np.concatenate([meta4[pick], on_card[1][pick]], axis=1)
    alns = decode_stream_batch(rows, params[pick, 0], params[pick, 1])
    for k, p in enumerate(pick):
        xl, yl, b, d = (int(v) for v in params[p])
        want = SwgExtend(b).extend(x[p, :xl].tobytes(), y[p, :yl].tobytes(), b, d)
        if alns[k] != want:
            raise AssertionError(f"row {p} ({params[p].tolist()}) differs from the oracle")
    log(f"kernel: {len(pick)} sampled rows ({min(len(fails), 300)} certificate "
        "failures) equal the scalar oracle")

    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*gpu))
        times.append(time.perf_counter() - t0)
    log(f"kernel on the card: median {statistics.median(times) * 1e3:.3f} ms per "
        f"{ROWS}-row chunk (min {min(times) * 1e3:.3f} ms) on {card}")

    import pytest

    os.environ["THERMITE_TEST_GPU"] = "1"
    here = os.path.dirname(os.path.abspath(__file__))
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(here, "tests", "test_stream_kernel.py")])
    if rc != 0:
        raise AssertionError(f"gpu-marked tests failed (pytest exit {rc})")


def workload():
    """(index artifact, chromosome bytes): the 45 Mbp synthetic
    chromosome standing in for GRCh38 chr21, cached under data/out/."""
    from thermite.index.build import Index
    from thermite.testing.synth import synth_index_artifact

    t0 = time.perf_counter()
    art = synth_index_artifact(OUT_DIR, 45_000_000, seed=1234, basename="bench_syn45")
    idx = Index.load(art)
    ref = idx.refs[0]
    chrom = bytes(idx.seq[ref.start_idx : ref.end_idx - 1])
    log(f"syn45 index ready in {time.perf_counter() - t0:.1f} s ({len(chrom)} bp)")
    return art, chrom


def write_reads(chrom, n, seed, name):
    from thermite.testing.synth import sample_reads, write_fastq_array

    path = os.path.join(SMOKE_DIR, name)
    write_fastq_array(path, sample_reads(chrom, n, seed))
    return path


def peak_mem():
    import jax

    return max(d.memory_stats().get("peak_bytes_in_use", 0) for d in jax.local_devices())


def phase_e2e(card):
    import numpy as np

    from thermite.testing.synth import write_fastq_array

    art, chrom = workload()
    os.makedirs(SMOKE_DIR, exist_ok=True)
    fq = write_reads(chrom, N_READS, 21, "reads.fq")
    out = lambda n: os.path.join(SMOKE_DIR, n)  # noqa: E731
    cfg = ["-k20", "-s0", "--intron-mode"]

    cold = align([art, fq, "-a", "-o", out("batch.bam")] + cfg, "batch (cold)")
    warm = align([art, fq, "-a", "-o", out("batch.bam")] + cfg, "batch")
    log(f"e2e batch: {N_READS / warm:.1f} reads/s warm ({warm:.2f} s), "
        f"{N_READS / cold:.1f} reads/s cold incl. compile ({cold:.2f} s), "
        f"peak device memory {peak_mem()} B, on {card}")
    tc = align([art, fq, "-a", "-o", out("cpp.bam")] + cfg + ["--engine", "cpp"], "cpp")
    n = same_bam(out("batch.bam"), out("cpp.bam"), "batch vs --engine cpp")
    log(f"e2e: batch BAM == --engine cpp BAM on all {N_READS} reads ({n} records); "
        f"cpp engine (all host cores) {N_READS / tc:.1f} reads/s")

    fq1k = out("reads_1k.fq")
    with open(fq) as src, open(fq1k, "w") as dst:
        for _ in range(4 * 1000):
            dst.write(src.readline())
    align([art, fq1k, "-a", "-o", out("oracle.bam")] + cfg + ["--engine", "oracle"], "oracle")
    _, want = bam_records(out("oracle.bam"))
    _, got = bam_records(out("batch.bam"))
    if got[: len(want)] != want or (len(got) > len(want) and got[len(want)][0] == want[-1][0]):
        raise AssertionError("batch BAM differs from --engine oracle on the first 1000 reads")
    log(f"e2e: batch BAM == --engine oracle BAM on the first 1000 reads ({len(want)} records)")

    # paired-end: FR fragments of 300 bp
    rng = np.random.default_rng(31)
    src = np.frombuffer(chrom, np.uint8)
    npairs = 50_000
    p = rng.integers(0, len(src) - 300, npairs)
    r1 = src[p[:, None] + np.arange(90)]
    comp = np.arange(256, dtype=np.uint8)
    comp[list(b"ACGT")] = list(b"TGCA")
    r2 = comp[src[p[:, None] + 210 + np.arange(90)][:, ::-1]]
    write_fastq_array(out("r1.fq"), r1, "p")
    write_fastq_array(out("r2.fq"), r2, "p")
    pargs = [art, out("r1.fq"), out("r2.fq"), "--paired", "-a"] + cfg
    tp = align(pargs + ["-o", out("pe_batch.bam")], "paired batch")
    align(pargs + ["-o", out("pe_cpp.bam"), "--engine", "cpp"], "paired cpp")
    n = same_bam(out("pe_batch.bam"), out("pe_cpp.bam"), "paired batch vs cpp")
    log(f"e2e paired: {2 * npairs / tp:.1f} reads/s; == --engine cpp ({n} records)")

    fq66 = write_reads(chrom, 100_000, 41, "reads66.fq")
    dargs = [art, fq66, "-a", "-k20", "-s0.66", "--intron-mode"]
    td = align(dargs + ["-o", out("d_batch.bam")], "-s0.66 batch")
    align(dargs + ["-o", out("d_cpp.bam"), "--engine", "cpp"], "-s0.66 cpp")
    n = same_bam(out("d_batch.bam"), out("d_cpp.bam"), "-s0.66 batch vs cpp")
    log(f"e2e -s0.66: {100_000 / td:.1f} reads/s (incl. compile of its shapes); "
        f"== --engine cpp ({n} records)")


def phase_mesh(card, n_cards):
    import jax
    import numpy as np

    from thermite.align.batch import BatchAligner
    from thermite.align.driver import AlignOpts
    from thermite.index.build import Index
    from thermite.parallel.mesh import make_mesh
    from thermite.testing.synth import sample_reads

    if len(jax.devices()) < n_cards:
        raise RuntimeError(f"--cards {n_cards}: JAX sees {len(jax.devices())} device(s)")
    art, chrom = workload()
    os.makedirs(SMOKE_DIR, exist_ok=True)

    # placement: text and read block on every card, problems on all
    opts = AlignOpts(min_seed_len=20, min_aln_score_percent=0.0, min_aln_score=30,
                     intron_mode=True)
    ba = BatchAligner(Index.load(art), opts, mesh=make_mesh(n_cards))
    reads = [r.tobytes() for r in sample_reads(chrom, 20_000, 5)]
    ba._RPAD = 96
    ba._pin_shapes(reads)
    st, _ = ba._build_chunk(reads, 0)
    ba._dispatch_forward(st)
    words, _ = ba._ref_text()
    for name, arr in (("text", words), ("read block", st.reads_dev)):
        devs = {s.device for s in arr.addressable_shards}
        if len(devs) != n_cards or not arr.sharding.is_fully_replicated:
            raise AssertionError(f"{name} is not replicated on all {n_cards} cards")
    shards = st.fwd_streams.addressable_shards
    if len({s.device for s in shards}) != n_cards or len({s.data.shape for s in shards}) != 1:
        raise AssertionError("problem rows do not shard evenly over all cards")
    log(f"mesh: text ({words.nbytes} B) and read block replicated on {n_cards} cards; "
        f"{st.fwd_streams.shape[0]} problem rows sharded {shards[0].data.shape[0]} per card")
    del ba, st, words

    fq = write_reads(chrom, N_READS, 21, "reads.fq")
    warm_fq = write_reads(chrom, 65_536, 3, "warm.fq")
    out = lambda n: os.path.join(SMOKE_DIR, n)  # noqa: E731
    cfg = ["-k20", "-s0", "--intron-mode", "-a"]
    align([art, warm_fq, "-o", out("w1.bam")] + cfg, "warm-up one card")
    align([art, warm_fq, "-o", out("w4.bam")] + cfg + ["--mesh", str(n_cards)], "warm-up mesh")
    t1 = align([art, fq, "-o", out("one.bam")] + cfg, "one card")
    tm = align([art, fq, "-o", out("mesh.bam")] + cfg + ["--mesh", str(n_cards)], "mesh")
    n = same_bam(out("mesh.bam"), out("one.bam"), f"--mesh {n_cards} vs one card")
    r1, rm = N_READS / t1, N_READS / tm
    log(f"mesh: --mesh {n_cards} BAM == one-card BAM ({n} records)")
    log(f"mesh: one card {r1:.1f} reads/s; {n_cards} cards {rm:.1f} reads/s = "
        f"{rm / n_cards:.1f} reads/s per card ({rm / r1 / n_cards:.3f} of linear), "
        f"peak device memory {peak_mem()} B, on {card}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4))
    args = ap.parse_args(argv)
    try:
        import thermite  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the thermite package is not importable ({e})", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    card, devs = phase_device()
    phase_build()
    if args.cards > 1:
        phase_mesh(card, args.cards)
    else:
        phase_kernel(card)
        phase_e2e(card)
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    import jax

    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:  # report, then fail without a result line
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
