"""Seconds of the span phase.scan (phasing/pipeline.py: decode of the input
BAM and each read's alleles at the het sites), summed over the window's
two-pass jobs (CallStats.phase of the second pass), per Gbase of read input.
Nothing to read in jobs without the record."""


def read(ctx):
    jobs = [j for j in ctx["jobs"] if j.get("phase")]
    if not jobs or not ctx["gbases"]:
        return None
    return sum(j["phase"]["scan_s"] for j in jobs) / ctx["gbases"]
