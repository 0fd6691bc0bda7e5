"""Entry points around the device path: the compile-cache location,
the synthetic workloads the smoke run and the bench use, and the
refusal of the GPU-only scripts to report anything off the card."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_honours_env(monkeypatch):
    import jax

    from thermite.cli import enable_compile_cache

    calls = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append((k, v)))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere/else")
    assert enable_compile_cache() == "/somewhere/else"
    assert calls == []  # no other directory is set in code


def test_compile_cache_defaults_inside_checkout(monkeypatch):
    import jax

    from thermite.cli import REPO_CACHE_DIR, enable_compile_cache

    calls = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append((k, v)))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert enable_compile_cache() == REPO_CACHE_DIR
    assert os.path.dirname(REPO_CACHE_DIR) == REPO
    assert ("jax_compilation_cache_dir", REPO_CACHE_DIR) in calls
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_small_genome_is_chrm_like(tmp_path):
    """The chrM stand-in: 16,569 bp, gene-dense, genes on both strands,
    overlapping neighbours and transcripts, reproducible from its seed."""
    from thermite.testing.synth import SMALL_GENOME_BP, write_small_genome

    fasta, gtf = write_small_genome(str(tmp_path / "a"))
    seq = open(fasta).read().split("\n", 1)[1].replace("\n", "")
    assert len(seq) == SMALL_GENOME_BP
    rows = [line.split("\t") for line in open(gtf).read().splitlines()]
    spans = sorted((int(r[3]) - 1, int(r[4]), r[6]) for r in rows)
    covered = np.zeros(SMALL_GENOME_BP, bool)
    for s, e, _ in spans:
        covered[s:e] = True
    assert covered.mean() > 0.9
    assert {st for _, _, st in spans} == {"+", "-"}
    assert any(b[0] < a[1] for a, b in zip(spans, spans[1:]))  # overlaps
    again = write_small_genome(str(tmp_path / "b"))
    assert open(again[0]).read() == open(fasta).read()
    assert open(again[1]).read() == open(gtf).read()


def test_sample_reads_shape_and_strands():
    from thermite.io.fastx import revcomp
    from thermite.testing.synth import sample_reads

    rng = np.random.default_rng(0)
    chrom = rng.choice(np.frombuffer(b"ACGT", np.uint8), 20_000).tobytes()
    reads = sample_reads(chrom, 400, seed=9, max_subst=0)
    assert reads.shape == (400, 90) and reads.dtype == np.uint8
    assert (sample_reads(chrom, 400, seed=9, max_subst=0) == reads).all()
    fwd = sum(r.tobytes() in chrom for r in reads)
    rc = sum(revcomp(r.tobytes()) in chrom for r in reads)
    assert fwd + rc == 400 and 100 < fwd < 300


def test_stream_problems_exercise_the_certificate():
    """The production-shape problem generator yields both certified rows
    and certificate failures, and no unterminated walks."""
    from thermite.ops.stream import smax_for, stream_rows, width_for_band
    from thermite.testing.synth import stream_problems

    x, y, params = stream_problems(512, 96, 128, 15, seed=4)
    assert x.shape == (512, 96) and y.shape == (512, 128)
    assert (params[:, 2] <= 15).all() and (params[:, 1] <= params[:, 0] + 16).all()
    meta4, _ = stream_rows(x, y, params, smax_for(90 + 106), width_for_band(15))
    ns = np.asarray(meta4)[:, 3]
    assert (ns >= 0).sum() > 256 and (ns <= -2).any() and not (ns == -1).any()


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_gpu(tmp_path, alone):
    """Off the card (here: JAX on the CPU) and in a directory holding
    nothing of the repo but the script, chip_smoke exits non-zero and
    prints no result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, script], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_bench_refuses_without_gpu():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py")], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert "no GPU" in r.stderr + r.stdout
