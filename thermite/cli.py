"""thermite command line: `index`, `align` and `merge` subcommands.

Flag surface and defaults match the reference CLI
(reference src/main.rs:87-153), with additions for batched execution:
``--engine {oracle,batch,cpp}`` picks the sequential CPU oracle, the
batched device pipeline or the all-native C++ engine, and
``--batch-size`` sizes device batches.
Output format selection matches src/main.rs:51-61: PAF by default,
``-a`` switches to SAM, or BAM when the output path ends in ``.bam``.
"""

from __future__ import annotations

import argparse
import os
import sys

from .align.driver import AlignOpts
from .align.run import FORMAT_BAM, FORMAT_PAF, FORMAT_SAM, align_reads_from_file
from .constants import (
    DEFAULT_MIN_ALN_SCORE,
    DEFAULT_MIN_ALN_SCORE_PERCENT,
    DEFAULT_MIN_SEED_LEN,
    DEFAULT_MULTIMAP_SCORE_RANGE,
)
from .index.build import Index


REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def enable_compile_cache() -> str:
    """Persist compiled kernels across processes and return the cache
    directory.  An explicit JAX_COMPILATION_CACHE_DIR is honoured as it
    is (JAX reads it itself); otherwise the cache lives at one fixed
    directory inside the checkout (``.jax_cache/``, git-ignored), so
    every entry point of one checkout shares it."""
    import jax

    d = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if d:
        return d
    os.makedirs(REPO_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return REPO_CACHE_DIR


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="thermite", description="spliced RNA-seq short-read aligner")
    p.add_argument("-v", "--verbose", action="store_true")

    # accept -v after the subcommand too (reference clap parses it
    # globally, src/main.rs:90); SUPPRESS keeps a pre-subcommand -v
    # from being clobbered by the subparser default
    class _SubParser(argparse.ArgumentParser):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.add_argument(
                "-v", "--verbose", action="store_true", default=argparse.SUPPRESS
            )

    sub = p.add_subparsers(dest="cmd", required=True, parser_class=_SubParser)

    pi = sub.add_parser("index", help="Index a reference")
    pi.add_argument("reference", help="reference FASTA")
    pi.add_argument("annotations", help="GTF annotations")
    pi.add_argument("-o", "--output", default="-", dest="index")
    # reference CLI compatibility (src/main.rs:97-102): this index
    # design has no suffix array / FM Occ table to sample — the seed
    # posting table's knob is --seed-stride.  Accepted so reference
    # invocations run unchanged; values are recorded but unused.
    pi.add_argument(
        "--sa-sampling-rate", type=int, default=32,
        help="accepted for thermite CLI compatibility (no suffix "
        "array in this index design; see --seed-stride)",
    )
    pi.add_argument(
        "--occ-sampling-rate", type=int, default=128,
        help="accepted for thermite CLI compatibility (no FM Occ "
        "table in this index design)",
    )
    pi.add_argument(
        "--seed-stride", type=int, default=None,
        help="sample every Nth text position in the seed table "
        "(default: 1 below 512 Mbp of concatenated text, 4 above — "
        "the whole-genome memory tradeoff; matches shorter than "
        "k+stride-1 may be missed)",
    )

    pa = sub.add_parser("align", help="Align reads to an indexed reference")
    pa.add_argument("index")
    pa.add_argument("queries", nargs="+")
    pa.add_argument("-o", "--output", default="-")
    pa.add_argument("-k", "--min-seed-len", type=int, default=DEFAULT_MIN_SEED_LEN)
    pa.add_argument(
        "-s",
        "--min-aln-score-percent",
        type=float,
        default=DEFAULT_MIN_ALN_SCORE_PERCENT,
    )
    pa.add_argument("--min-aln-score", type=int, default=DEFAULT_MIN_ALN_SCORE)
    pa.add_argument(
        "--multimap-score-range", type=int, default=DEFAULT_MULTIMAP_SCORE_RANGE
    )
    pa.add_argument("-a", dest="bam", action="store_true", help="SAM/BAM output")
    pa.add_argument("--intron-mode", action="store_true")
    pa.add_argument(
        "--engine", choices=["oracle", "batch", "cpp"], default="batch",
        help="batch = device pipeline; oracle = sequential Python referee; "
        "cpp = all-native single-core baseline (SAM/BAM only)",
    )
    pa.add_argument("--batch-size", type=int, default=16384)
    pa.add_argument(
        "--threads", type=int, default=0, metavar="N",
        help="host worker threads for chunk build / table build / the "
        "cpp engine's DP loop (0 = auto: THERMITE_THREADS env, else "
        "all cores); output is thread-count-invariant",
    )
    # paired-end (BEYOND reference parity — the reference is
    # single-end; see align/paired.py)
    pa.add_argument(
        "--paired", action="store_true",
        help="treat the two query files as R1/R2 mates (requires "
        "exactly two inputs and SAM/BAM output; fills pair flags, "
        "RNEXT/PNEXT/TLEN)",
    )
    pa.add_argument(
        "--max-insert", type=int, default=1000, metavar="N",
        help="max template length for a proper pair (paired mode)",
    )
    pa.add_argument(
        "--no-mate-rescue", action="store_true",
        help="disable searching an unmapped mate inside its mapped "
        "partner's insert window (paired mode)",
    )
    pa.add_argument(
        "--profile", default=None, metavar="DIR",
        help="write a jax.profiler (XProf) trace of the run to DIR",
    )
    # multi-chip / multi-host data parallelism (SURVEY §7 M5): reads
    # shard across hosts in contiguous blocks (order-preserving; merge
    # shards with `thermite merge`), and each host spreads its
    # extension problems over a local device mesh
    pa.add_argument(
        "--mesh", type=int, default=0, metavar="N",
        help="data-parallel mesh over N local devices (0 = single "
        "device; -1 = all local devices)",
    )
    pa.add_argument(
        "--num-hosts", type=int, default=1,
        help="total aligner hosts; this host aligns its contiguous "
        "block of the input reads and writes OUTPUT.shardNNN",
    )
    pa.add_argument(
        "--host-id", type=int, default=None,
        help="this host's rank in [0, num-hosts)",
    )
    pa.add_argument(
        "--coordinator", default=None, metavar="HOST:PORT",
        help="jax.distributed coordinator address (multi-host "
        "slices; optional — shard mode also runs fully independent "
        "processes, the reference's embarrassingly-parallel contract)",
    )

    pm = sub.add_parser(
        "merge",
        help="Merge per-host output shards (host order) into one file",
    )
    pm.add_argument("-o", "--output", required=True)
    pm.add_argument("shards", nargs="+")

    args = p.parse_args(argv)

    if args.cmd == "align":
        enable_compile_cache()

    if args.cmd == "merge":
        from .parallel.multihost import merge_shards, sniff_shard_format

        out = args.output
        if out.endswith(".bam"):
            fmt = "bam"
        elif out.endswith(".sam"):
            fmt = "sam"
        elif out.endswith(".paf"):
            fmt = "paf"
        else:
            # unrecognized extension: sniff the first shard's magic
            # instead of silently defaulting (a BAM merged as PAF would
            # be a garbled concatenation)
            fmt = sniff_shard_format(args.shards[0])
        merge_shards(args.shards, out, fmt)
        return 0

    if args.cmd == "index":
        index = Index.create_from_files(args.reference, args.annotations)
        if args.verbose:
            index.print_stats()
        out = args.index
        if out == "-":
            raise SystemExit("index output to stdout not supported; pass -o FILE")
        stride = args.seed_stride
        if stride is None:
            stride = 1 if len(index.seq) < (512 << 20) else 4
        index.build_seed_table(stride=stride)
        index.save(out)  # Index.save normalizes to the .npz artifact name
        return 0

    if not 0.0 <= args.min_aln_score_percent <= 1.0:
        # explicit check (asserts vanish under python -O); message text
        # matches reference src/main.rs:46-49
        raise SystemExit("Min alignment score percent must be between 0.0 and 1.0!")
    if args.bam:
        fmt = FORMAT_BAM if args.output.endswith(".bam") else FORMAT_SAM
    else:
        fmt = FORMAT_PAF

    shard = None
    output = args.output
    if args.num_hosts > 1:
        host_id = args.host_id
        if host_id is None:
            raise SystemExit("--num-hosts requires --host-id")
        if not 0 <= host_id < args.num_hosts:
            raise SystemExit("--host-id must be in [0, num-hosts)")
        if args.coordinator:
            import jax

            jax.distributed.initialize(
                coordinator_address=args.coordinator,
                num_processes=args.num_hosts,
                process_id=host_id,
            )
        shard = (host_id, args.num_hosts)
        if output != "-":
            output = f"{output}.shard{host_id:03d}"

    mesh = None
    if args.mesh:
        from .parallel.mesh import make_mesh

        import jax

        n = len(jax.local_devices()) if args.mesh < 0 else args.mesh
        mesh = make_mesh(n)

    if args.paired:
        # cheap usage validation before the (multi-GB) index load
        if len(args.queries) != 2:
            raise SystemExit("--paired requires exactly two query files (R1 R2)")
        if fmt == FORMAT_PAF:
            raise SystemExit("--paired writes SAM/BAM only (pass -a)")

    if args.threads:
        # one knob for every native host stage (chunk build, table
        # build, cpp-engine DP): they all read THERMITE_THREADS
        os.environ["THERMITE_THREADS"] = str(args.threads)
    index = Index.load(args.index)
    if getattr(index, "seed_table", None) is not None and not isinstance(
        index.seed_table, tuple
    ):
        # genome-scale packed-table artifact: stream the mmap members in
        # once — seeding/extension otherwise cold-fault them 4 KB at a
        # time at random offsets (measured ~1000x slower on chunk one)
        index.warm_mmap()
    # the loaded index is a large, immortal object graph (transcript
    # lists, interval tables); freeze it out of the generational GC so
    # the collections between batches stop re-traversing it
    import gc

    gc.freeze()
    opts = AlignOpts(
        min_seed_len=args.min_seed_len,
        min_aln_score_percent=args.min_aln_score_percent,
        min_aln_score=args.min_aln_score,
        multimap_score_range=args.multimap_score_range,
        intron_mode=args.intron_mode,
    )
    if args.paired:
        from .align.paired import align_paired_from_files

        align_paired_from_files(
            index,
            args.queries[0],
            args.queries[1],
            output,
            fmt,
            opts,
            engine=args.engine,
            batch_size=args.batch_size,
            max_insert=args.max_insert,
            verbose=args.verbose,
            shard=shard,
            mesh=mesh,
            mate_rescue=not args.no_mate_rescue,
        )
        return 0
    align_reads_from_file(
        index,
        args.queries,
        output,
        fmt,
        opts,
        engine=args.engine,
        batch_size=args.batch_size,
        verbose=args.verbose,
        profile_dir=args.profile,
        shard=shard,
        mesh=mesh,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
