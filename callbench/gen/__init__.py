"""The benchmark's data: a traffic mix's contigs simulated from a seed
(simulate.py) and written as BAM + FASTA by the benchmark's own writer
(bam.py), one contig a child process."""
