#!/usr/bin/env python
"""Roofline and limiter split of the port's fused pass on the card (the
PyTorch/CUDA counterpart of tools/roofline.py).

Over bench_torch.py's main dataset, its chunks staged on the device as the
fused route stages them (v2 wire unless CLAIR3_RNA_TORCH_TILELET_WIRE says
otherwise), three nested slices of the fused pass are timed
stream-ordered: every chunk's work enqueued back to back between two CUDA
events, one synchronize at the end, best of 3 after a warm pass:

  1. kernel_only -- the tilelet expansion kernel (K1, csrc/tilelet.cu)
                    alone, called as the fused route calls it;
  2. front_end   -- the fused pass's window-fetch entry point: K1, the
                    sparse star/indel side channel, the i1 patch, the
                    reference negation and the 33-window gather, up to
                    the network (no mask, no network, no prescreen);
  3. full_graph  -- the whole fused pass.

front_end - kernel_only is the tail around the kernel, full_graph -
front_end the candidate mask, network and prescreen. The byte bound of
the kernel counts what its launches must move (chip_smoke.py's bound()):
each tile's rows read once (crumbs, validity, rank, strand), the tile
offsets, and 40 f32 a position written, over the H100's HBM rate.

    python tools/torch_roofline.py [--quick] [--device cuda|cpu]
                                   [--data-dir DIR]

Writes TORCH_ROOFLINE.json (--quick: <data-dir>/torch_roofline_quick.json)
and prints it as one JSON line. Raises without a card unless --device cpu
(whose times are CPU times).
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

H100_HBM_BPS = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)


def kernel_bytes(st):
    """What one K1/K2 launch on a staged chunk must move."""
    from clair3_rna_torch.ops import tilelet as tlt
    row = (st.tl_codes.shape[1] + 4 + 1
           + (st.tl_valid.shape[1] if st.tl_valid is not None else 0))
    return (int(st.tl_row_off[-1]) * row + st.tl_row_off.nbytes
            + (tlt.C_PAD + tlt.G_PAD) * st.width * 4)


def measure(chunks, wire, params, cfg, n_best=3):
    """The three slices' stream-ordered seconds (best of n_best), the
    kernel launches of one kernel_only sweep, and the candidates of one
    full_graph sweep (the header of each chunk's output)."""
    import torch
    import bench_torch
    from clair3_rna_torch.ops import tilelet as tlt
    from clair3_rna_torch.ops.fused_pileup import make_fused_fn

    device = params.device
    fn = make_fused_fn(params, cfg, max_candidates=1024, wire=wire)
    sel = torch.arange(1024, dtype=torch.int32, device=device)
    args = [(c["packed_tensors"], c["core"]) for c in chunks]

    def kern(t):
        return tlt.expand(wire, t["tl_codes"], t["tl_valid"], t["tl_tile"],
                          t["tl_rank"], t["tl_strand"],
                          t["ref_code"].shape[0], tl_hp=t["tl_hp"],
                          phased=False, tl_row_off=t["tl_row_off"],
                          max_rows=t["tl_max_rows"])

    slices = {
        "kernel_only": [lambda t=t: kern(t) for t, _ in args],
        "front_end": [lambda t=t, c=c: fn(t, c, sel=sel) for t, c in args],
        "full_graph": [lambda t=t, c=c: fn(t, c) for t, c in args],
    }
    for calls in slices.values():  # first passes: allocator, first launches
        bench_torch.stream_seconds(calls, device)
    tlt.reset_launches()
    bench_torch.stream_seconds(slices["kernel_only"], device)
    launches = dict(tlt.launches)
    n_candidates = sum(int(c()[0, 0].item()) for c in slices["full_graph"])
    secs = {name: min(bench_torch.stream_seconds(calls, device)
                      for _ in range(n_best))
            for name, calls in slices.items()}
    return secs, launches, n_candidates


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--data-dir", default=None)
    args = ap.parse_args(argv)

    import torch
    import bench_torch
    from clair3_rna_torch import resolve_device
    from clair3_rna_torch.config import PileupConfig
    from clair3_rna_torch.models.params_io import params_from_numpy

    device = resolve_device(args.device)   # raises without a card
    if args.data_dir:
        bench_torch.DATA_DIR = os.path.abspath(args.data_dir)
    sizes = bench_torch.QUICK if args.quick else bench_torch.FULL
    torch.backends.cuda.matmul.allow_tf32 = False
    card = bench_torch.card_line() if device.type == "cuda" else None

    fasta_path, bam_path = bench_torch._dataset(*sizes["main"][:4])
    params = params_from_numpy(bench_torch.get_trained_params(sizes, device),
                               device=device)
    cfg = PileupConfig(batch_size=2048)
    chunks, wire = bench_torch.stage_bench_chunks(
        bam_path, fasta_path, cfg, sizes["chunk_size"], device)
    secs, launches, n_cand = measure(chunks, wire, params, cfg)

    n_events = sum(c["n_events"] for c in chunks)
    k_bytes = sum(kernel_bytes(c["packed"]) for c in chunks)
    bound_s = k_bytes / H100_HBM_BPS
    bytes_per_event = k_bytes / max(n_events, 1)
    roofline_eps = H100_HBM_BPS / bytes_per_event
    k, f, g = (secs["kernel_only"], secs["front_end"], secs["full_graph"])
    result = {
        "device": {"type": device.type, "card": card,
                   "kind": torch.cuda.get_device_name(0)
                   if device.type == "cuda" else "cpu"},
        "quick": bool(args.quick), "wire": wire,
        "n_chunks": len(chunks), "n_events": int(n_events),
        "n_candidates": n_cand,
        "total_rows": int(sum(int(c["packed"].tl_row_off[-1])
                              for c in chunks)),
        "total_tiles": int(sum(c["packed"].width // 256 for c in chunks)),
        "kernel_launches": launches,
        "kernel_only_s": k, "front_end_s": f, "full_graph_s": g,
        "tail_s": max(f - k, 0.0), "mask_network_s": max(g - f, 0.0),
        "kernel_share_of_full": k / g, "tail_share_of_full": max(f - k, 0) / g,
        "mask_network_share_of_full": max(g - f, 0) / g,
        "kernel_events_per_s": n_events / k,
        "front_end_events_per_s": n_events / f,
        "full_graph_events_per_s": n_events / g,
        "kernel_bytes": int(k_bytes),
        "hbm_bytes_per_event": bytes_per_event,
        "hbm_bound_s": bound_s,
        "roofline_events_per_s": roofline_eps,
        # a share of the card's bound only from a card's time
        "kernel_pct_of_roofline": 100.0 * bound_s / k
        if device.type == "cuda" else None,
        "hbm_bps": H100_HBM_BPS,
        "note": ("stream-ordered best of 3 (CUDA events, one synchronize); "
                 "kernel_only = K1 as the fused route calls it, front_end "
                 "= the fused pass's window fetch (no mask/network), "
                 "full_graph = the whole fused pass; the bound counts the "
                 "bytes the kernel's launches must move over the HBM rate"),
    }
    out = (os.path.join(bench_torch.DATA_DIR,
                                    "torch_roofline_quick.json")
                       if args.quick else os.path.join(REPO,
                                                       "TORCH_ROOFLINE.json"))
    with open(out, "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
