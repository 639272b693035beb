"""95th percentile of a chunk's build seconds (the joblog's build_seconds of
every chunk of the window's jobs, each pass), in ms."""

from statistics import quantiles


def read(ctx):
    secs = [float(row["build_seconds"]) for job in ctx["jobs"]
            for rows in job.get("joblog_rows", []) for row in rows]
    if len(secs) < 20:
        return None
    return quantiles(secs, n=20)[18] * 1e3
