"""Share of the jobs' walls the main thread spent blocked on chunk builds:
the joblog's wait_s (the span pipeline.wait, caller/pipeline.py) summed
over every chunk, over the passes' run_calling walls, in %. Nothing to
read in a joblog without the column."""


def read(ctx):
    wait = wall = 0.0
    for job in ctx["jobs"]:
        for rows, stats in zip(job.get("joblog_rows", []), job["stats"]):
            if rows and "wait_s" in rows[0]:
                wait += sum(float(r["wait_s"]) for r in rows)
                wall += stats["wall_s"]
    if not wall:
        return None
    return 100.0 * wait / wall
