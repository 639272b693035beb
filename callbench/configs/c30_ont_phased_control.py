#!/usr/bin/env python3
"""The control of configuration c30_ont_phased's check: the plain reference
put in the program's place for the second pass, its phasing model in TF32
(the precision below the configuration's float32 with TF32 off), judged by
the cell's own second-pass numbers and limits at the cell's own size. Its
phased_prob_gap has to come out over the limit.

    python3 callbench/configs/c30_ont_phased_control.py --seeds <n> [<n> ...]
        [--workload c30_ont_phased.expr_skew.fused]

Prints one JSON line a seed: the numbers, the limits and whether the
control was (rightly) judged not correct. The benchmark's runs never run
this; it holds the limits up. The first pass stays in float32, so the
reads' haplotags are the reference's own.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

WORKLOAD = "c30_ont_phased.expr_skew.fused"


def control_numbers(cfg, traffic, seed, device, root=ROOT, tf32=True):
    """The cell's second-pass numbers with the reference (its phasing model
    in TF32 when `tf32`) in the program's place."""
    from callbench.reference.judge import expected_rows, judge
    from callbench.reference.network import load_weights, probabilities
    from callbench.reference.twopass import two_pass

    ref = two_pass(traffic, seed, cfg, range(int(traffic["contigs"])),
                   device, root)
    w = load_weights(os.path.join(root, cfg["weights"]))
    fp32 = {n: probabilities(w, c.tensors, device)
            for n, c in ref.phased.items()}
    ctl = {n: probabilities(w, c.tensors, device, tf32=tf32)
           for n, c in ref.phased.items()}
    caps = [(n, c.tensors, ctl[n]) for n, c in ref.phased.items()]
    bodies = [(n, expected_rows(c, ctl[n], cfg["qual_cutoff"]))
              for n, c in ref.phased.items()]
    nums = judge(ref.phased, fp32, caps, bodies, cfg["qual_cutoff"])
    return {"phased_" + k: v for k, v in nums.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default=WORKLOAD)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    from callbench.harness import load_cell
    from callbench.run import limits_for

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("the control runs in TF32, which needs a CUDA card")
    _, cfg, traffic, _ = load_cell(args.workload)
    limits = limits_for(args.workload)
    for seed in args.seeds:
        nums = control_numbers(cfg, traffic, seed, args.device)
        over = {k: v for k, v in nums.items() if v > limits[k]}
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "numbers": nums, "limits": limits,
                          "judged_not_correct": bool(over)}), flush=True)


if __name__ == "__main__":
    main()
