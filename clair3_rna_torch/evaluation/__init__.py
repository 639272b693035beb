"""Evaluation and stand-alone tools; so far the phasing tool (`phase_bam`)."""
