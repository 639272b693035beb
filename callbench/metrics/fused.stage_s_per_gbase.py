"""Seconds of host staging and the host-to-device copies (the spans chunk.stage
and chunk.h2d: stage_chunk_packed, sparse_indels, staged_tensors), summed
over the window's fused-attempted chunks (the joblog's stage_s + h2d_s;
thread-summed: the two prefetch threads overlap), per Gbase of read input.
Nothing to read without fused chunks or the columns."""


def read(ctx):
    rows = [r for job in ctx["jobs"] for rows in job.get("joblog_rows", [])
            for r in rows if r.get("route") in ("fused", "fallback")]
    if not rows or not ctx["gbases"]:
        return None
    return sum(float(r["stage_s"]) + float(r["h2d_s"])
               for r in rows) / ctx["gbases"]
