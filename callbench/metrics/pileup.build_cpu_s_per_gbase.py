"""Chunk build seconds (CallStats.build_s, summed over the prefetch threads
and each pass) per Gbase of read input."""


def read(ctx):
    if not ctx["gbases"]:
        return None
    return sum(s["build_s"] for job in ctx["jobs"] for s in job["stats"]) \
        / ctx["gbases"]
