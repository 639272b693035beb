"""Share of the profiled job's trace window in which no kernel, copy or
memset ran on the device, in %."""


def read(ctx):
    act = ctx.get("activity")
    if not act or act["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - act["busy_s"] / act["window_s"])
