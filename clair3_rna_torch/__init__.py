"""Clair3-RNA on PyTorch and CUDA: long-read RNA-seq small-variant calling.

A port of the JAX package `clair3_rna_tpu` to one NVIDIA GPU. It keeps that
package's module layout; the JAX package stays the reference the port is
held against, and nothing here imports it.

Layering (bottom-up):
  config, task -- pipeline constants, platform presets, label spaces
  io           -- FASTA/.fai, BGZF, BAM/BAI, VCF, BED readers & writers
  native       -- C++ BAM decode, tile builder and packed-read extractor
  pileup       -- read events, channel-count builder, packed read rows
  models       -- PyTorch Bi-LSTM pileup network + weight I/O
  csrc, ops    -- CUDA kernels (tilelet expansion, event scatter, channel
                  counts), fused chunk pass
  caller       -- pipeline, backend choice, host genotype decode -> VCF
  postprocess  -- merge/sort/LowQual/REDIportal tagging

Float32 matmuls run in full precision: the 33-step recurrence compounds
TF32's ~1e-3 relative error into probability shifts that flip rounded QUALs
(the JAX package saw the same with the TPU's reduced-precision f32 dots).
"""

import torch

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None):
    """torch.device for an entry point: "cuda" unless the caller asks for
    "cpu". A CUDA request on a machine without CUDA raises -- there is no
    silent CPU fallback."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda|cpu)")
    return dev
