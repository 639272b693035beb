"""Variant caller: device-side probability pre-screen + host-side genotype
decode into VCF records (redesign of clair3_rna/call_variants.py)."""
