"""Self-contained genomics I/O: FASTA/.fai, BGZF, BAM, VCF, BED.

The reference pipeline shells out to samtools/htslib + bgzip/tabix for all of
this (shared/utils.py:168-194, src/create_tensor_pileup.py:438-451,
src/sort_vcf.py:70-75); this package implements the needed subset natively so
the engine has no external tool dependencies on the host.
"""

from clair3_rna_torch.io.fasta import FastaFile, write_fasta
from clair3_rna_torch.io.bam import BamReader, BamWriter, BamRecord
from clair3_rna_torch.io.bgzf import BgzfReader, BgzfWriter, bgzf_compress, bgzf_decompress
