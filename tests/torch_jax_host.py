"""The JAX package's host route on a numpy weight tree, for the tests that
hold the port's instruments to the JAX package: the same dataset and the
same weights through clair3_rna_tpu.caller.pipeline.run_calling.

JAX is imported inside the function, so a test file that imports this
module still collects on a machine without JAX."""


def to_jax(tree):
    import jax.numpy as jnp
    import numpy as np
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    return jnp.asarray(np.asarray(tree))


def jax_host_body(bam, fasta, out, tree, *, chunk_size, contigs=None,
                  batch_size=2048):
    """run_calling of the JAX package (host route, no RefCall rows, plain
    VCF) -> (the VCF body, the candidates it counted)."""
    from clair3_rna_tpu.caller.decode import CallConfig
    from clair3_rna_tpu.caller.pipeline import run_calling
    from clair3_rna_tpu.config import PileupConfig
    from clair3_rna_tpu.models.network import make_wire_forward_fn

    _, forward = make_wire_forward_fn()
    _, stats = run_calling(
        bam, fasta, out, cfg=PileupConfig(batch_size=batch_size),
        call_cfg=CallConfig(show_ref=False), params=to_jax(tree),
        forward=forward, contigs=contigs, chunk_size=chunk_size,
        compress=False, progress=False)
    with open(out) as f:
        body = [line for line in f if not line.startswith("#")]
    return body, stats.candidates
