#!/usr/bin/env python3
"""The control of a cell's check: the plain reference put in the program's
place, its network in TF32 (the precision below the configuration's
float32 with TF32 off), judged by the cell's own numbers and limits at the
cell's own size. Its prob_gap has to come out over the limit.

    python3 callbench/control.py --workload <name> --seeds <n> [<n> ...]

Prints one JSON line a seed: the numbers, the limits and whether the
control was (rightly) judged not correct. The benchmark's runs never run
this; it holds the limits up.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def control_numbers(cfg, traffic, seed, device, root=ROOT, tf32=True):
    """The cell's numbers with the reference (in TF32 when `tf32`) in the
    program's place."""
    from callbench.reference.judge import all_candidates, expected_rows, judge
    from callbench.reference.network import load_weights, probabilities

    cands = all_candidates(traffic, seed, cfg, range(int(traffic["contigs"])))
    by_name = {c.contig: c for c in cands.values()}
    w = load_weights(os.path.join(root, cfg["weights"]))
    ref = {n: probabilities(w, c.tensors, device) for n, c in by_name.items()}
    ctl = {n: probabilities(w, c.tensors, device, tf32=tf32)
           for n, c in by_name.items()}
    caps = [(n, c.tensors, ctl[n]) for n, c in by_name.items()]
    bodies = [(n, expected_rows(c, ctl[n], cfg["qual_cutoff"]))
              for n, c in by_name.items()]
    return judge(by_name, ref, caps, bodies, cfg["qual_cutoff"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
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
