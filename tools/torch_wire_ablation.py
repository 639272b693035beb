#!/usr/bin/env python
"""Tilelet-wire ablation on the card: the nibble wire (K2, 4 bits a slot)
against the v2 wire (K1, 2-bit crumbs + a validity bit), the PyTorch/CUDA
counterpart of tools/wire_ablation.py.

For each wire, on bench_torch.py's main dataset: the wire bytes and the
fused pass's device throughput over chunks staged on the device
(bench_torch.bench_fused_device: per-chunk fetch and stream-ordered), the
kernel launches of that wire, then the fused route end to end through
run_calling. The end-to-end VCF bodies must be identical to each other and
to the host route's.

    python tools/torch_wire_ablation.py [--quick] [--device cuda|cpu]
                                        [--data-dir DIR]

Writes TORCH_WIRE_ABLATION.json (--quick: <data-dir>/
torch_wire_ablation_quick.json) and prints a summary line. Raises without
a card unless --device cpu (whose times are CPU times).
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--data-dir", default=None)
    args = ap.parse_args(argv)

    import torch
    import bench_torch
    from clair3_rna_torch import resolve_device
    from clair3_rna_torch.caller.decode import CallConfig
    from clair3_rna_torch.config import PileupConfig
    from clair3_rna_torch.models.network import make_wire_forward_fn
    from clair3_rna_torch.models.params_io import params_from_numpy
    from clair3_rna_torch.ops import tilelet as tlt

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
    call_cfg = CallConfig(show_ref=False)
    _, forward = make_wire_forward_fn()
    bench_torch.warm_network(params, forward, cfg, sizes["warm_batches"])
    chunk = sizes["chunk_size"]
    n_e2e = 1 if args.quick else 2
    n_timed = sizes["runs"]["device"]
    out_vcf = bam_path + ".bench_out.vcf"

    out = {"device": {"type": device.type, "card": card,
                      "kind": torch.cuda.get_device_name(0)
                      if device.type == "cuda" else "cpu"},
           "quick": bool(args.quick)}
    out["host"] = bench_torch.timed_runs(bam_path, fasta_path, cfg, call_cfg,
                                         params, forward, n_runs=1,
                                         chunk_size=chunk)
    bodies = {"host": bench_torch._vcf_body(out_vcf)}
    for wire in ("nibble", "v2"):
        os.environ["CLAIR3_RNA_TORCH_TILELET_WIRE"] = wire
        try:
            tlt.reset_launches()
            dev = bench_torch.bench_fused_device(
                bam_path, fasta_path, params, cfg, chunk, n_timed=n_timed,
                ablation=False)
            dev["launches"] = {k: v for k, v in tlt.launches.items() if v}
            e2e = bench_torch.timed_runs(bam_path, fasta_path, cfg, call_cfg,
                                         params, forward, n_runs=n_e2e,
                                         chunk_size=chunk, backend="fused")
            bodies[wire] = bench_torch._vcf_body(out_vcf)
        finally:
            os.environ.pop("CLAIR3_RNA_TORCH_TILELET_WIRE", None)
        out[wire] = {"device": dev, "e2e": e2e}
    for wire in ("nibble", "v2"):
        if bodies[wire] != bodies["host"]:
            raise RuntimeError(f"the {wire} wire's fused VCF differs from "
                               f"the host route's: {len(bodies[wire])} vs "
                               f"{len(bodies['host'])} rows")
    out["vcf_identical"] = True
    out["n_rows"] = len(bodies["host"])
    out["wire_mb"] = {w: out[w]["device"]["wire_mb"] for w in ("nibble", "v2")}
    out["shrink"] = round(out["wire_mb"]["nibble"]
                          / max(out["wire_mb"]["v2"], 1e-9), 3)
    out["device_stream_s"] = {w: out[w]["device"]["device_stream_s"]
                              for w in ("nibble", "v2")}
    out["e2e_sites_per_s"] = {w: out[w]["e2e"]["sites_per_s"]
                              for w in ("nibble", "v2", "host")
                              if w != "host"}
    out["e2e_sites_per_s"]["host"] = out["host"]["sites_per_s"]
    path = (os.path.join(bench_torch.DATA_DIR,
                                     "torch_wire_ablation_quick.json")
                        if args.quick else
                        os.path.join(REPO, "TORCH_WIRE_ABLATION.json"))
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps({k: out[k] for k in (
        "device", "wire_mb", "shrink", "device_stream_s", "e2e_sites_per_s",
        "vcf_identical", "n_rows")}))
    return out


if __name__ == "__main__":
    main()
