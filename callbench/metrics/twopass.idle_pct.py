"""Share of the profiled two-pass job's trace window in which no kernel, copy
or memset ran on the device (both passes and the phase + haplotag step
between them), in %. device.idle_pct's reader under the two-pass cell's
own name."""

import os

from callbench.harness import file_module

read = file_module(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "device.idle_pct.py"),
                   "callbench_metric_device.idle_pct").read
