"""Benchmarking / evaluation toolkit (the reference's src/ offline tools) and
the stand-alone phasing tool (`phase_bam`)."""
