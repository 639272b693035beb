"""The two networks' share of one H100's float32 peak over the window of the
two-pass cell: 2 x the multiply-adds of every candidate row both passes ran
(18 channels in the first, 30 in the re-call; padding rows not counted),
over the window's seconds x 67 TFLOP/s, in %. step.mfu_pct's reader under
the two-pass cell's own name."""

import os

from callbench.harness import file_module

read = file_module(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "step.mfu_pct.py"),
                   "callbench_metric_step.mfu_pct").read
