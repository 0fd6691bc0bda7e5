"""Whole-genome scale demonstration: index + align a >=3 Gbp genome.

The reference indexes any genome (i64 suffix array,
reference src/index.rs:104); GRCh38 (3.1 Gbp, 6.2 Gbp concatenated
fwd+rc text) is the Cell Ranger production target but its blobs are
git-LFS-elided, so this tool synthesizes a GRCh38-scale genome
(multi-chromosome, spliced genes, chr21-like density), indexes it with
a stride-sampled seed table (STAR-sparse-SA-style; see
csrc thermite_seed_index_new_stride), aligns reads on the GPU
through the nibble-packed resident-text pipeline, spot-checks
byte-parity vs the sequential CPU oracle, scores ground-truth
accuracy, and prints one JSON line with the measured numbers.

Usage: python tools/genome_scale.py [total_Gbp] [n_reads] [stride]
       (defaults 3.2, 65536, 4)
       --resume: skip synth/index/table/save and load the previously
       saved data/out/genome_scale/wg_index.npz artifact (use after a
       crash past the build phase; pass --table-s SECONDS to carry the
       measured table-build time into the JSON).

Artifacts land under data/out/genome_scale/ (gitignored; ~50 GB for
the 3.2 Gbp default — build takes ~10-20 min on this 1-core host, the
aligned run a few minutes).
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from thermite.align.batch import BatchAligner  # noqa: E402
from thermite.align.driver import AlignOpts, OracleAligner  # noqa: E402
from thermite.index.build import Index  # noqa: E402
from thermite.testing.synth import (  # noqa: E402
    make_truth_reads,
    write_synth_genome,
)


def log(msg):
    print(f"[genome_scale +{time.time() - T0:7.1f}s] {msg}", file=sys.stderr)


T0 = time.time()


def main():
    # positional args = everything that is neither a --flag nor the
    # value of a value-taking flag
    raw = sys.argv[1:]
    args = []
    skip = False
    for i, a in enumerate(raw):
        if skip:
            skip = False
            continue
        if a == "--table-s":
            if i + 1 >= len(raw):
                sys.exit("--table-s needs a value (seconds)")
            skip = True
            continue
        if a.startswith("--"):
            continue
        args.append(a)
    total_bp = int(float(args[0]) * 1e9) if len(args) > 0 else 3_200_000_000
    n_reads = int(args[1]) if len(args) > 1 else 65536
    stride = int(args[2]) if len(args) > 2 else 4
    out_dir = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "data", "out", "genome_scale",
    )
    n_chroms = max(total_bp // 200_000_000, 1)

    save_s = load_s = table_s = -1.0
    if "--table-s" in sys.argv:
        table_s = float(sys.argv[sys.argv.index("--table-s") + 1])

    if "--resume" in sys.argv:
        # a prior run crashed after the (expensive) build+save phase;
        # reload the persisted artifact and rerun only the align phase
        art = os.path.join(out_dir, "wg_index.npz")
        log(f"resuming from artifact {art} "
            f"({os.path.getsize(art) / 1e9:.1f} GB)")
        t = time.time()
        idx = Index.load(art)
        load_s = time.time() - t
        log(f"artifact reloaded in {load_s:.0f} s")
        warm_s = idx.warm_mmap()
        log(f"mmap members warmed in {warm_s:.0f} s")
        text_len = len(idx.seq)
        total_bp = sum(r.len for r in idx.refs if r.strand)
    else:
        fasta = os.path.join(out_dir, "wg.fasta")
        gtf = os.path.join(out_dir, "wg.gtf")
        # the generator is seed-deterministic, so an existing wg.fasta
        # whose size matches THIS total_bp (bases + per-chromosome
        # header/newline overhead, < 1%) is this exact genome; a stale
        # file from a different scale must NOT be silently reused
        sz = os.path.getsize(fasta) if os.path.exists(fasta) else -1
        if (
            total_bp <= sz <= int(total_bp * 1.01) + 4096
            and os.path.exists(gtf)
            and "--fresh" not in sys.argv
        ):
            log(f"reusing existing {fasta}")
        else:
            log(f"synthesizing {total_bp / 1e9:.2f} Gbp across "
                f"{n_chroms} chromosomes")
            fasta, gtf = write_synth_genome(
                out_dir, total_bp, seed=2024, n_chroms=n_chroms, basename="wg"
            )
        log("parsing + concatenating (fwd+rc)")
        idx = Index.create_from_files(fasta, gtf)
        text_len = len(idx.seq)
        log(f"text {text_len / 1e9:.2f} GB, {len(idx.txome.txs)} transcripts; "
            f"building stride-{stride} seed table")
        t_table = time.time()
        idx.build_seed_table(stride=stride)
        table_s = time.time() - t_table
        st = idx.seed_table
        npos = len(st.kv) if hasattr(st, "kv") else len(st[3])
        log(f"seed table built in {table_s:.0f} s "
            f"({npos / 1e9:.2f}G positions)")

        # artifact round trip: persist the whole-genome index (incl. the
        # posting table) and reload it; alignment below runs on the
        # RELOADED index, proving the production save/load path at scale
        if "--no-artifact" not in sys.argv:
            art = os.path.join(out_dir, "wg_index.npz")
            t = time.time()
            idx.save(art)
            save_s = time.time() - t
            art_gb = os.path.getsize(art) / 1e9
            log(f"artifact saved in {save_s:.0f} s ({art_gb:.1f} GB)")
            del idx
            t = time.time()
            idx = Index.load(art)
            load_s = time.time() - t
            log(f"artifact reloaded in {load_s:.0f} s")
            log(f"mmap members warmed in {idx.warm_mmap():.0f} s")

    opts = AlignOpts(
        min_seed_len=20, min_aln_score_percent=0.0, min_aln_score=30,
        intron_mode=True,
    )
    reads = make_truth_reads(idx, n_reads, seed=31)
    seqs = [r[1] for r in reads]

    log("constructing BatchAligner (nibble pack + device upload on first batch)")
    batch = BatchAligner(idx, opts)
    t_up = time.time()
    batch._ref_text()  # host nibble pack + HBM upload, timed separately
    up_s = time.time() - t_up
    log(f"resident text packed+uploaded in {up_s:.0f} s")

    warm = seqs[:8192]
    t_warm = time.time()
    batch.align_batch(warm)
    log(f"warmup (compiles) {time.time() - t_warm:.0f} s")

    batch.stats.reset()
    t_run = time.time()
    out = batch.align_batch(seqs)
    run_s = time.time() - t_run
    rps = len(seqs) / run_s
    mapped = sum(1 for o in out if o)
    log(f"aligned {len(seqs)} reads in {run_s:.1f} s = {rps:.0f} reads/s "
        f"({mapped / len(seqs):.3f} mapped)")
    print(batch.stats.report(), file=sys.stderr)

    # ground-truth accuracy (primary alignment overlaps its true locus)
    ok = 0
    for (name, _), alns in zip(reads, out):
        _, chrom, s, e, strand = name.rsplit(":", 4)
        for ga in alns:
            if not ga.primary:
                continue
            if (
                ga.ref_name == chrom
                and (ga.strand != (strand == "-"))
                and ga.gx_aln.ystart < int(e)
                and ga.gx_aln.yend > int(s)
            ):
                ok += 1
            break
    log(f"truth overlap (primary): {ok / len(reads):.4f}")

    # spot parity vs the sequential oracle (shared strided seed table)
    log("spot parity vs CPU oracle")
    oracle = OracleAligner(idx, opts)
    rng = np.random.default_rng(5)
    spot = rng.choice(len(seqs), 300, replace=False)
    mismatch = 0
    for i in spot:
        a = oracle.align_read(seqs[i])
        b = out[i]
        sa = [(g.ref_name, g.strand, g.gx_aln.ystart, g.gx_aln.yend,
               g.gx_aln.score, g.primary, g.gx_aln.operations) for g in a]
        sb = [(g.ref_name, g.strand, g.gx_aln.ystart, g.gx_aln.yend,
               g.gx_aln.score, g.primary, g.gx_aln.operations) for g in b]
        mismatch += sa != sb
    log(f"oracle spot check: {len(spot) - mismatch}/{len(spot)} identical")

    result = {
        "metric": "e2e_align_reads_per_s_wholegenome",
        "genome_bp": total_bp,
        "text_bytes": text_len,
        "seed_stride": stride,
        "value": round(rps, 1),
        "unit": "reads/s",
        "mapped_fraction": round(mapped / len(seqs), 4),
        "truth_overlap_primary": round(ok / len(reads), 4),
        "oracle_spot_mismatches": int(mismatch),
        "table_build_s": round(table_s, 1),
        "text_upload_s": round(up_s, 1),
        "artifact_save_s": round(save_s, 1),
        "artifact_load_s": round(load_s, 1),
    }
    with open(os.path.join(out_dir, "genome_scale.json"), "w") as f:
        json.dump(result, f)
    print(json.dumps(result))
    return 1 if mismatch else 0


if __name__ == "__main__":
    sys.exit(main())
