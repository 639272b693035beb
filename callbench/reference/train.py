#!/usr/bin/env python3
"""Train a configuration's weights with a plain trainer of the reference
side: the reference's own pileup (reference/pileup.py) of contigs made by
the benchmark's generator, labels from the generator's planted truth,
Clair3-RNA's network as torch.nn.LSTM and torch.nn.Linear layers, Adam on
the two heads' cross-entropy. Nothing of the program runs.

    python3 callbench/reference/train.py --config c18_ont [--device cuda]
        [--out DIR]

Writes <config>.npz (the Keras layout reference/network.py reads) and
<config>.recipe.json (the recipe, the seconds, the card and the npz's
SHA-256) into --out (default: callbench/weights). On one card the same
recipe gives the same bytes: seeded initialisation and batch order,
deterministic cuDNN and cuBLAS.
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

RECIPE = {"traffic": "expr_skew", "contigs": 2, "seed": 20240917,
          "epochs": 12, "batch_size": 256, "lr": 1e-3, "init_seed": 7}


def labels(ctg, cands):
    """[n] gt21 class and [n] zygosity class of each candidate, from the
    generator's planted variants (none: the reference base twice, 0/0)."""
    from callbench.gen.simulate import DEL, INS
    from callbench.reference import task
    text = ctg.ref_text()
    v = ctg.variants
    at = ctg.variant_at()[cands.pos]
    gt21 = np.array([task.gt21_from_label(text[p] * 2) for p in cands.pos.tolist()])
    zyg = np.zeros(len(at), np.int64)
    for i in np.nonzero(at >= 0)[0].tolist():
        k, p = int(at[i]), int(cands.pos[i])
        if v.kind[k] == INS:
            alt = text[p] + "".join("ACGT"[c] for c in v.ins[k])
            ref = text[p]
        elif v.kind[k] == DEL:
            ref, alt = text[p:p + 1 + int(v.del_len[k])], text[p]
        else:
            ref, alt = text[p], "ACGT"[v.alt[k]]
        g1, g2 = (int(x) for x in v.gt[k])
        gt21[i] = task.gt21_enum_from(ref, alt, g1, g2)
        zyg[i] = task.genotype_enum_for_task(task.genotype_enum_from(g1, g2))
    return gt21, zyg


def training_set(traffic, recipe, params):
    from callbench.reference.judge import all_candidates
    from callbench.gen.simulate import make_contig
    cands = all_candidates(traffic, recipe["seed"], params,
                           range(recipe["contigs"]))
    xs, g, z = [], [], []
    for i, c in sorted(cands.items()):
        a, b = labels(make_contig(traffic, recipe["seed"], i), c)
        xs.append(c.tensors)
        g.append(a)
        z.append(b)
    return np.concatenate(xs), np.concatenate(g), np.concatenate(z)


def make_net(channels):
    import torch
    from torch import nn

    class Net(nn.Module):
        """Clair3_P with the logits before each softmax exposed."""

        def __init__(self):
            super().__init__()
            self.lstm1 = nn.LSTM(channels, 128, batch_first=True, bidirectional=True)
            self.lstm2 = nn.LSTM(256, 160, batch_first=True, bidirectional=True)
            self.l4 = nn.Linear(33 * 320, 128)
            self.heads = nn.ModuleDict({
                name: nn.Sequential(nn.Linear(128, 128), nn.SELU(),
                                    nn.Linear(128, n), nn.SELU())
                for name, n in (("gt21", 21), ("genotype", 3))})

        def forward(self, x):
            h, _ = self.lstm1(x)
            h, _ = self.lstm2(h)
            h = torch.selu(self.l4(h.reshape(h.shape[0], -1)))
            return self.heads["gt21"](h), self.heads["genotype"](h)
    return Net()


def keras_layout(net):
    """{"lstm1/forward/kernel": [in, 4h], ...}: one bias a direction (the
    sum of torch's two)."""
    out = {}
    sd = {k: v.detach().cpu().numpy().astype(np.float32)
          for k, v in net.state_dict().items()}
    for name in ("lstm1", "lstm2"):
        for d, suffix in (("forward", ""), ("backward", "_reverse")):
            out[f"{name}/{d}/kernel"] = sd[f"{name}.weight_ih_l0{suffix}"].T.copy()
            out[f"{name}/{d}/recurrent_kernel"] = sd[f"{name}.weight_hh_l0{suffix}"].T.copy()
            out[f"{name}/{d}/bias"] = (sd[f"{name}.bias_ih_l0{suffix}"]
                                       + sd[f"{name}.bias_hh_l0{suffix}"])
    out["l4/kernel"], out["l4/bias"] = sd["l4.weight"].T.copy(), sd["l4.bias"]
    for name in ("gt21", "genotype"):
        for j, part in ((0, "dense"), (2, "logits")):
            out[f"{name}_{part}/kernel"] = sd[f"heads.{name}.{j}.weight"].T.copy()
            out[f"{name}_{part}/bias"] = sd[f"heads.{name}.{j}.bias"]
    return out


def train(x, gt21, zyg, channels, recipe, device):
    import torch
    torch.manual_seed(recipe["init_seed"])
    net = make_net(channels).to(device)
    opt = torch.optim.Adam(net.parameters(), lr=recipe["lr"])
    xt = torch.from_numpy(x.astype(np.float32)).to(device)
    gt = torch.from_numpy(gt21).to(device)
    zt = torch.from_numpy(zyg).to(device)
    order_gen = torch.Generator().manual_seed(recipe["init_seed"])
    bs = recipe["batch_size"]
    losses = []
    for _ in range(recipe["epochs"]):
        order = torch.randperm(len(xt), generator=order_gen).to(device)
        total = torch.zeros((), device=device)
        for lo in range(0, len(order), bs):
            idx = order[lo:lo + bs]
            a, b = net(xt[idx])
            loss = (torch.nn.functional.cross_entropy(a, gt[idx])
                    + torch.nn.functional.cross_entropy(b, zt[idx]))
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            total += loss.detach() * len(idx)
        losses.append(float(total) / len(xt))
    return net, losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="c18_ont")
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
    x, gt21, zyg = training_set(traffic, recipe, cfg)
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
    recipe.update(rows=len(x), variant_rows=int((zyg > 0).sum()),
                  losses=[round(v, 6) for v in losses],
                  pileup_s=round(t1 - t0, 3), train_s=round(time.time() - t1, 3),
                  device=card, torch=torch.__version__,
                  sha256=hashlib.sha256(data).hexdigest())
    with open(os.path.join(args.out, args.config + ".recipe.json"), "w") as f:
        json.dump(recipe, f, indent=1)
    print(json.dumps(recipe))


if __name__ == "__main__":
    main()
