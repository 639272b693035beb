#!/usr/bin/env python3
"""Train the phasing model's weights (30 channels) with the reference side's
plain trainer: train.py's recipe, labels, network and Adam, on the
30-channel reference pileup of the recipe's contigs, whose reads are phased
from the reference's own first-pass calls on the first pass's weights
(reference/twopass.py). Nothing of the program runs.

    python3 callbench/reference/train_phased.py [--config c30_ont_phased]
        [--device cuda] [--out DIR]

Writes <config>.npz and <config>.recipe.json into --out (default:
callbench/weights), as train.py does. On one card the same recipe gives the
same bytes.
"""

import argparse
import hashlib
import io
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from callbench.reference.train import (RECIPE, keras_layout, labels,  # noqa: E402
                                       train)


def training_set(traffic, recipe, cfg, device):
    """30-channel tensors, gt21 and zygosity classes of the recipe's
    contigs."""
    from callbench.gen.simulate import make_contig
    from callbench.reference.twopass import two_pass
    ref = two_pass(traffic, recipe["seed"], cfg, range(recipe["contigs"]),
                   device, ROOT)
    xs, g, z = [], [], []
    for i in range(recipe["contigs"]):
        ctg = make_contig(traffic, recipe["seed"], i)
        c = ref.phased[ctg.name]
        a, b = labels(ctg, c)
        xs.append(c.tensors)
        g.append(a)
        z.append(b)
    tagged = sum(int((hp > 0).sum()) for hp in ref.hp.values())
    reads = sum(len(hp) for hp in ref.hp.values())
    return np.concatenate(xs), np.concatenate(g), np.concatenate(z), \
        tagged, reads


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="c30_ont_phased")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(ROOT, "callbench", "weights"))
    ap.add_argument("--epochs", type=int, default=RECIPE["epochs"])
    args = ap.parse_args(argv)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    with open(os.path.join(ROOT, "callbench", "configs", args.config + ".json")) as f:
        cfg = json.load(f)
    recipe = dict(RECIPE, epochs=args.epochs)
    with open(os.path.join(ROOT, "callbench", "traffic",
                           recipe["traffic"] + ".json")) as f:
        traffic = json.load(f)
    t0 = time.time()
    x, gt21, zyg, tagged, reads = training_set(traffic, recipe, cfg,
                                               args.device)
    t1 = time.time()
    net, losses = train(x, gt21, zyg, cfg["channels"], recipe, args.device)
    buf = io.BytesIO()
    np.savez(buf, **keras_layout(net))
    data = buf.getvalue()
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, args.config + ".npz"), "wb") as f:
        f.write(data)
    card = (torch.cuda.get_device_name(0) if torch.device(args.device).type == "cuda"
            else "cpu")
    recipe.update(first_pass_weights=cfg["first_pass_weights"],
                  first_pass_weights_sha256=cfg["first_pass_weights_sha256"],
                  rows=len(x), variant_rows=int((zyg > 0).sum()),
                  tagged_reads=tagged, reads=reads,
                  hp_channel_rows=int((np.abs(x[:, :, 18:]).sum(axis=(1, 2))
                                       > 0).sum()),
                  losses=[round(v, 6) for v in losses],
                  pileup_s=round(t1 - t0, 3), train_s=round(time.time() - t1, 3),
                  device=card, torch=torch.__version__,
                  sha256=hashlib.sha256(data).hexdigest())
    with open(os.path.join(args.out, args.config + ".recipe.json"), "w") as f:
        json.dump(recipe, f, indent=1)
    print(json.dumps(recipe))


if __name__ == "__main__":
    main()
