"""Device-mesh parallelism and multi-process sharded calling.

The reference's only parallelism is OS-process data parallelism over genome
chunks via GNU parallel (run_clair3_rna:681-707, SURVEY 2.3). Here, as in
the JAX package, candidate batches shard over the 'dp' axis of a device
mesh with weights replicated (or tensor-sharded over 'tp'), and genome
chunks shard across processes (parallel/distributed.py).
"""

from clair3_rna_torch.parallel.mesh import (
    make_mesh, sharded_forward_fn, sharded_train_step_fn,
)
