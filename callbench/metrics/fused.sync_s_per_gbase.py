"""Seconds spent waiting for the fused pass's output on the host (the span
chunk.sync: .cpu(), which also waits for the other thread's work queued on
the shared stream), summed over the window's fused-attempted chunks (the
joblog's sync_s; thread-summed: the two prefetch threads overlap), per Gbase
of read input. Nothing to read without fused chunks or the columns."""


def read(ctx):
    rows = [r for job in ctx["jobs"] for rows in job.get("joblog_rows", [])
            for r in rows if r.get("route") in ("fused", "fallback")]
    if not rows or not ctx["gbases"]:
        return None
    return sum(float(r["sync_s"]) for r in rows) / ctx["gbases"]
