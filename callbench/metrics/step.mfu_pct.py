"""The network's share of one H100's float32 peak over the window: 2 x the
multiply-adds of every candidate row the window's jobs ran (padding rows
not counted), over the window's seconds x 67 TFLOP/s, in %."""

from callbench.lib.peaks import H100_FP32_FLOPS, flops_per_row


def read(ctx):
    flops = 0
    for job in ctx["jobs"]:
        for channels, rows in job["network_rows"].items():
            cfg = dict(ctx["cfg"], channels=int(channels))
            flops += rows * flops_per_row(cfg)
    if not flops:
        return None
    return 100.0 * flops / (ctx["window_s"] * H100_FP32_FLOPS)
