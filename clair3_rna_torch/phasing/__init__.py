"""Read-backed phasing + haplotagging.

In-framework replacement for the external whatshap/longphase dependency the
reference shells out to for its --enable_phasing_model pass
(run_clair3_rna:729-801): phase first-pass heterozygous SNVs from read
co-occurrence, then tag reads with HP so the 30-channel phasing model can
consume per-haplotype counts.
"""
