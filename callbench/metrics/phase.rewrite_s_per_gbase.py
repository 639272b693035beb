"""Seconds of the span phase.rewrite (phasing/pipeline.py: decode, tag,
re-encode and deflate of every record, the writer's close and the tagged
BAM's index), summed over the window's two-pass jobs (CallStats.phase of the
second pass), per Gbase of read input. Nothing to read in jobs without the
record."""


def read(ctx):
    jobs = [j for j in ctx["jobs"] if j.get("phase")]
    if not jobs or not ctx["gbases"]:
        return None
    return sum(j["phase"]["rewrite_s"] for j in jobs) / ctx["gbases"]
