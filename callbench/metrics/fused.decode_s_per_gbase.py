"""Seconds of host decode and the escape paths (the spans chunk.decode and
chunk.escape: _alt, decode_batch, the renorm and splice-hatch rows), summed
over the window's fused-attempted chunks (the joblog's decode_s + escape_s;
thread-summed: the two prefetch threads overlap), per Gbase of read input.
Nothing to read without fused chunks or the columns."""


def read(ctx):
    rows = [r for job in ctx["jobs"] for rows in job.get("joblog_rows", [])
            for r in rows if r.get("route") in ("fused", "fallback")]
    if not rows or not ctx["gbases"]:
        return None
    return sum(float(r["decode_s"]) + float(r["escape_s"])
               for r in rows) / ctx["gbases"]
