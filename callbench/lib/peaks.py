"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W) and the network's operations, counted from its widths."""

H100_FP32_FLOPS = 67e12        # float32 outside the tensor cores (TF32 off)


def flops_per_row(cfg):
    """2 x the multiply-adds of one candidate row through Clair3_P: two
    BiLSTMs over 33 positions (input and recurrent matmuls, 4 gates, two
    directions), the flattening dense layer and the two heads."""
    t, c = cfg["positions"], cfg["channels"]
    u1, u2 = cfg["lstm1_units"], cfg["lstm2_units"]
    d, h = cfg["dense_units"], cfg["head_units"]
    mac = t * 2 * 4 * u1 * (c + u1)
    mac += t * 2 * 4 * u2 * (2 * u1 + u2)
    mac += t * 2 * u2 * d
    mac += sum(d * h + h * n for n in cfg["outputs"].values())
    return 2 * mac
