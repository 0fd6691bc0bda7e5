"""Shared tiny end-to-end fixture.

Designed from scratch (sequences deliberately distinct from the
reference's test data) with equivalent behavioural coverage:
exact match, reverse-complement match, unmapped, spliced reads with
and without errors, '-'-strand spliced genes, within-chromosome
multimaps, and intronic/intergenic classification.

Layout:
* alpha  (14bp) — '+' gene with one exon [1,12); contains the repeat
  ATTACA at 1 and 8 (exonic + intronic multimap).
* beta   (14bp) — no annotations; used for revcomp genome matches.
* gamma  (26bp) — '+' gene, tx1 with 3 exons [5,8)+[13,16)+[21,26)
  (spliced seq ATTGACTTAAC) and tx2 skipping the middle exon
  (spliced seq ATTTTAAC).
* delta  (26bp) — same sequence as gamma but the gene is annotated on
  the '-' strand with the same exon coordinates (spliced seq
  GTTAAGTCAAT); exercises revcomp-copy exon lifting.
* epsilon(16bp) — no annotations; intergenic source.
"""

ALPHA = "GATTACAGATTACA"
BETA = "ACCTGAGAGTTCAG"
GAMMA = "GCGCG" + "ATT" + "CGCGC" + "GAC" + "GCGCG" + "TTAAC"
EPSILON = "CATGGCTAGCTAACTG"

FASTA = f""">alpha
{ALPHA}
>beta
{BETA}
>gamma
{GAMMA}
>delta
{GAMMA}
>epsilon
{EPSILON}
"""

# GTF is 1-based inclusive.
GTF = "\n".join(
    [
        'alpha\t.\tgene\t2\t12\t.\t+\t.\tgene_id "alpha_g"; gene_name "ALPHA1"',
        'alpha\t.\ttranscript\t2\t12\t.\t+\t.\tgene_id "alpha_g"; transcript_id "alpha_tx"',
        'alpha\t.\texon\t2\t12\t.\t+\t.\tgene_id "alpha_g"; transcript_id "alpha_tx"',
        'gamma\t.\tgene\t6\t26\t.\t+\t.\tgene_id "gamma_g"; gene_name "GAMMA1"',
        'gamma\t.\ttranscript\t6\t26\t.\t+\t.\tgene_id "gamma_g"; transcript_id "gamma_tx1"',
        'gamma\t.\texon\t6\t8\t.\t+\t.\tgene_id "gamma_g"; transcript_id "gamma_tx1"',
        'gamma\t.\texon\t14\t16\t.\t+\t.\tgene_id "gamma_g"; transcript_id "gamma_tx1"',
        'gamma\t.\texon\t22\t26\t.\t+\t.\tgene_id "gamma_g"; transcript_id "gamma_tx1"',
        'gamma\t.\ttranscript\t6\t26\t.\t+\t.\tgene_id "gamma_g"; transcript_id "gamma_tx2"',
        'gamma\t.\texon\t6\t8\t.\t+\t.\tgene_id "gamma_g"; transcript_id "gamma_tx2"',
        'gamma\t.\texon\t22\t26\t.\t+\t.\tgene_id "gamma_g"; transcript_id "gamma_tx2"',
        'delta\t.\tgene\t6\t26\t.\t-\t.\tgene_id "delta_g"; gene_name "DELTA1"',
        'delta\t.\ttranscript\t6\t26\t.\t-\t.\tgene_id "delta_g"; transcript_id "delta_tx1"',
        'delta\t.\texon\t6\t8\t.\t-\t.\tgene_id "delta_g"; transcript_id "delta_tx1"',
        'delta\t.\texon\t14\t16\t.\t-\t.\tgene_id "delta_g"; transcript_id "delta_tx1"',
        'delta\t.\texon\t22\t26\t.\t-\t.\tgene_id "delta_g"; transcript_id "delta_tx1"',
    ]
)

# (name, sequence) query reads; quality = '9' * len.
READS = [
    ("exact_exonic", "ATTACAG"),  # alpha[1:8), inside the exon
    ("revcomp_genome", "ACTCTCAG"),  # revcomp(beta[2:10))
    ("unmapped", "TGTGTGTGTGTGTGTG"),
    ("unmapped_n", "NNNNNNNNNN"),
    ("spliced_tx1", "ATTGACTTAAC"),  # gamma tx1 exactly
    ("spliced_tx2", "ATTTTAAC"),  # gamma tx2 exactly
    ("spliced_err1", "ATTGTCTTAAC"),  # tx1 with one subst in exon 2
    ("spliced_revcomp", "GTTAAGTCAA"),  # delta_tx1[0:10) ('-' strand tx)
    ("multimap", "ATTACA"),  # alpha at 1 (exonic) and 8 (intronic)
    ("intron_exon", "CGCGCGAC"),  # gamma[8:16): intron + exon 2, unspliced
    ("intergenic", "TGGCTAGCTA"),  # epsilon[2:12)
]

FASTQ = "".join(f"@{name}\n{seq}\n+\n{'9' * len(seq)}\n" for name, seq in READS)


def write_fixture(tmp_path):
    ref = tmp_path / "mini_ref.fasta"
    gtf = tmp_path / "mini_ref.gtf"
    fq = tmp_path / "mini_query.fastq"
    ref.write_text(FASTA)
    gtf.write_text(GTF)
    fq.write_text(FASTQ)
    return str(ref), str(gtf), str(fq)


def small_genome_index(tmp_dir):
    """Index of the seeded chrM stand-in (testing/synth.py
    write_small_genome): 16.5 kb, gene-dense, both strands."""
    from thermite.index.build import Index
    from thermite.testing.synth import write_small_genome

    fasta, gtf = write_small_genome(str(tmp_dir))
    return Index.create_from_files(fasta, gtf)
