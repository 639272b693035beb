"""Share of the jobs' walls outside the chunk loop: each pass's run_calling
wall less the span from its first chunk's starttime to its last chunk's
donetime (the joblog's epoch columns), summed, over the walls summed, in
%: the serial head (planning, set-up) and tail (sort, bgzip, tabix)."""


def read(ctx):
    serial = wall = 0.0
    for job in ctx["jobs"]:
        for rows, stats in zip(job.get("joblog_rows", []), job["stats"]):
            if rows and "starttime" in rows[0]:
                loop = (max(float(r["donetime"]) for r in rows)
                        - min(float(r["starttime"]) for r in rows))
                serial += stats["wall_s"] - loop
                wall += stats["wall_s"]
    if not wall:
        return None
    return 100.0 * serial / wall
