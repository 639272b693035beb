"""Seconds of host time launching the fused pass, front end and network (the
span chunk.launch, overflow reruns included), summed over the window's
fused-attempted chunks (the joblog's launch_s; thread-summed: the two
prefetch threads overlap), per Gbase of read input. Nothing to read without
fused chunks or the columns."""


def read(ctx):
    rows = [r for job in ctx["jobs"] for rows in job.get("joblog_rows", [])
            for r in rows if r.get("route") in ("fused", "fallback")]
    if not rows or not ctx["gbases"]:
        return None
    return sum(float(r["launch_s"]) for r in rows) / ctx["gbases"]
