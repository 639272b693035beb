"""Plain PyTorch forward pass of Clair3-RNA's pileup network (Clair3_P,
clair3_rna/model.py:88-216): BiLSTM(128) -> BiLSTM(160) -> flatten ->
Dense(128, selu) -> two heads, each Dense(128, selu) -> Dense(selu) ->
softmax; gt21 (21) then zygosity (3).

Weights are read from the npz (Keras layout: kernel [in, out], LSTM gates
i, f, g, o, one bias a direction) into torch.nn.LSTM, whose gate order is
the same; its second bias is zero. In float32 with TF32 off unless `tf32`
is set, which is the control's precision.
"""

import numpy as np
import torch
from torch import nn

HEADS = (("gt21", 21), ("genotype", 3))


class RefNet(nn.Module):
    def __init__(self, weights):
        super().__init__()
        w = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in weights.items()}
        in_ch = w["lstm1/forward/kernel"].shape[0]
        self.lstm1 = nn.LSTM(in_ch, 128, batch_first=True, bidirectional=True)
        self.lstm2 = nn.LSTM(256, 160, batch_first=True, bidirectional=True)
        with torch.no_grad():
            for name, lstm in (("lstm1", self.lstm1), ("lstm2", self.lstm2)):
                for d, suffix in (("forward", ""), ("backward", "_reverse")):
                    getattr(lstm, "weight_ih_l0" + suffix).copy_(w[f"{name}/{d}/kernel"].T)
                    getattr(lstm, "weight_hh_l0" + suffix).copy_(
                        w[f"{name}/{d}/recurrent_kernel"].T)
                    getattr(lstm, "bias_ih_l0" + suffix).copy_(w[f"{name}/{d}/bias"])
                    getattr(lstm, "bias_hh_l0" + suffix).zero_()
        self.dense = {k[:-len("/kernel")]: (w[k], w[k[:-len("kernel")] + "bias"])
                      for k in w if k.endswith("/kernel") and not k.startswith("lstm")}

    def _lin(self, name, x):
        k, b = self.dense[name]
        return x @ k.to(x.device) + b.to(x.device)

    def forward(self, x):
        h, _ = self.lstm1(x)
        h, _ = self.lstm2(h)
        h = torch.selu(self._lin("l4", h.reshape(h.shape[0], -1)))
        outs = [torch.softmax(torch.selu(self._lin(f"{name}_logits", torch.selu(
            self._lin(f"{name}_dense", h)))), dim=-1) for name, _ in HEADS]
        return torch.cat(outs, dim=-1)


def load_weights(path):
    """npz -> {"layer/.../name": float32 array}."""
    with np.load(path) as z:
        return {k: z[k].astype(np.float32) for k in z.files}


def probabilities(weights, tensors, device, tf32=False, block=8192):
    """[n, 33, C] int tensors -> [n, 24] float32 probabilities (numpy),
    computed in blocks of rows on `device`."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        net = RefNet(weights).to(device).eval()
        out = []
        with torch.inference_mode():
            for lo in range(0, len(tensors), block):
                x = torch.from_numpy(np.ascontiguousarray(
                    tensors[lo:lo + block], np.float32)).to(device)
                out.append(net(x).cpu().numpy())
        return np.concatenate(out) if out else np.zeros((0, 24), np.float32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
