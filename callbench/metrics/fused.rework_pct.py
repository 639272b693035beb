"""Wasted device passes of the fused route: overflow reruns (the joblog's
retries) plus chunks that fell back to the host build (route fallback),
over the chunks the fused route attempted (route fused or fallback), in
%. Nothing to read without fused chunks."""


def read(ctx):
    rows = [r for job in ctx["jobs"] for rows in job.get("joblog_rows", [])
            for r in rows if r.get("route") in ("fused", "fallback")]
    if not rows:
        return None
    wasted = sum(int(r["retries"]) + (r["route"] == "fallback")
                 for r in rows)
    return 100.0 * wasted / len(rows)
