"""Share of the network's slabs that replayed a CUDA graph in the two-pass
cell, over both passes' fused-attempted chunks (the first pass's 18-channel
slots and the re-call's 30-channel ones, two networks resident), in %.
net.graph_slab_pct's reader under the two-pass cell's own name: it reads
every joblog of a job, and a two-pass job has two."""

import os

from callbench.harness import file_module

read = file_module(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "net.graph_slab_pct.py"),
                   "callbench_metric_net.graph_slab_pct").read
