"""thermite: a spliced (transcriptome-aware) short-read RNA aligner with
the capabilities of 10XGenomics/thermite, re-designed for batched
execution with JAX/XLA on a GPU (NVIDIA H100).

Layer map (bottom-up, mirroring the capability set in SURVEY.md §1):

* ``ops``      — banded SWG extension kernels: exact scalar oracle,
                 batched JAX ``lax.scan`` kernel, the single-pass stream
                 kernel (forward + certificate + traceback walk).
* ``seed``     — SMEM seeding: k-mer posting tables searched by the
                 native C++ engine, replacing the reference's FM-index
                 search.
* ``index``    — reference index: concatenated fwd+revcomp genome,
                 k-mer tables, transcriptome model, .tai artifact.
* ``align``    — seed→extend→arbitrate driver (oracle + batched device
                 pipeline + all-native C++ engine).
* ``io``       — FASTA/FASTQ/GTF parsing, SAM/BAM/PAF writing.
* ``parallel`` — device mesh / sharding helpers for data-parallel
                 read alignment across devices and hosts.
"""

__version__ = "0.1.0"
