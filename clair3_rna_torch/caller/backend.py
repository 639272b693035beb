"""Pileup backend selection: host C++ tile builder vs the fused device pass.

- "host": the C++ tile builder makes the count image on the host and only
  candidate windows reach the device, which runs the network.
- "fused": packed reads are staged to the device and the whole chunk
  (tilelet expansion, count image, candidate mask, window gather, network,
  prescreen) runs as one device pass (ops/fused_pileup).
- "auto": "host" until both routes have been measured on the GPU and a
  rule can be drawn from the measurements.

Both routes emit identical VCF rows. The JAX package's per-chunk "hybrid"
router is not ported yet.
"""

import logging
import os

logger = logging.getLogger(__name__)


def choose_backend():
    """-> (backend, reason) for --pileup_backend auto."""
    return "host", ("no measured rule yet for choosing the fused route on "
                    "a GPU")


def resolve_backend(requested=None):
    """Final backend from the CLI flag / env var / auto.

    Precedence: explicit argument, then CLAIR3_RNA_TORCH_PILEUP_BACKEND,
    then "host". "device" and "kernel" name the pure-array builder's count
    backends (pileup/builder.py reads the same variable), so at the
    pipeline level they mean "not the fused route"."""
    backend = (requested
               or os.environ.get("CLAIR3_RNA_TORCH_PILEUP_BACKEND")
               or "host")
    if backend == "auto":
        backend, reason = choose_backend()
        logger.info("[INFO] pileup backend auto-selected: %s (%s)",
                    backend, reason)
    if backend in ("device", "kernel"):
        return "host"
    if backend == "hybrid":
        raise NotImplementedError(
            "--pileup_backend hybrid: the per-chunk router is not ported yet "
            "(ROADMAP Queue 1 item 5)")
    if backend not in ("host", "fused"):
        raise ValueError(f"bad pileup backend: {backend!r} "
                         "(expected auto|host|fused)")
    return backend
