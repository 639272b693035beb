"""Host decode seconds (CallStats.decode_s, each pass) per Gbase of read
input. The fused route decodes inside its chunk pass, which build_s holds:
there this reader finds nothing."""


def read(ctx):
    secs = sum(s["decode_s"] for job in ctx["jobs"] for s in job["stats"])
    if not secs or not ctx["gbases"]:
        return None
    return secs / ctx["gbases"]
