"""Share of the window's two-pass job walls spent in phase + haplotag: Σ the
span `phase` (phasing/pipeline.py; the record the program's second pass
returns as CallStats.phase) over Σ the jobs' walls (the configuration's
job, both passes and the phase step), in %. Nothing to read in jobs
without the record."""


def read(ctx):
    jobs = [j for j in ctx["jobs"] if j.get("phase") and j.get("wall_s")]
    if not jobs:
        return None
    return 100.0 * sum(j["phase"]["phase_s"] for j in jobs) \
        / sum(j["wall_s"] for j in jobs)
