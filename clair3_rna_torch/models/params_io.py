"""Model parameter serialization (.npz -- the JAX package's layout).

Keys are "/"-joined paths of the parameter tree, e.g.
`lstm1/forward/kernel` or `gt21_logits/bias`, with Keras-layout arrays, so
an npz written by either package loads in the other.
"""

import os

import numpy as np
import torch

from clair3_rna_torch import resolve_device
from clair3_rna_torch.models.network import PileupNet

# npz path segment <-> PileupNet attribute (an nn.Module cannot have a
# child named "forward")
_DIR_TO_ATTR = {"forward": "fwd", "backward": "bwd"}
_ATTR_TO_DIR = {v: k for k, v in _DIR_TO_ATTR.items()}


def _flatten(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict):
            out.update(_flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def _unflatten(flat):
    tree = {}
    for path, value in flat.items():
        parts = path.split("/")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def params_from_numpy(tree, device=None):
    """Parameter tree of numpy arrays (JAX layout) -> PileupNet on `device`
    (CUDA unless the caller asks for "cpu"). The input width (18 or 30
    channels) and the indel-length heads are read off the tree."""
    device = resolve_device(device)
    flat = _flatten(tree)
    in_channels = flat["lstm1/forward/kernel"].shape[0]
    net = PileupNet(add_indel_length="length1_dense/kernel" in flat,
                    in_channels=in_channels)
    state = {}
    for path, arr in flat.items():
        parts = [_DIR_TO_ATTR.get(p, p) for p in path.split("/")]
        state[".".join(parts)] = torch.from_numpy(
            np.array(arr, dtype=np.float32))
    net.load_state_dict(state, strict=True)
    return net.requires_grad_(False).to(device).eval()


def params_to_numpy(net):
    """PileupNet -> parameter tree of float32 numpy arrays (JAX layout)."""
    flat = {}
    for name, value in net.state_dict().items():
        parts = [_ATTR_TO_DIR.get(p, p) for p in name.split(".")]
        flat["/".join(parts)] = value.detach().cpu().numpy()
    return _unflatten(flat)


def save_params(path: str, params) -> str:
    """Write a PileupNet (or a numpy parameter tree) as .npz."""
    if not path.endswith(".npz"):
        path += ".npz"
    tree = params_to_numpy(params) if isinstance(params, PileupNet) \
        else params
    np.savez_compressed(path, **_flatten(tree))
    return path


def load_params(path: str):
    """.npz -> numpy parameter tree."""
    with np.load(path) as data:
        return _unflatten({k: data[k] for k in data.files})


def resolve_params(path_or_prefix: str, add_indel_length=False):
    """Numpy parameter tree from .npz, or from a TF checkpoint prefix."""
    if path_or_prefix.endswith(".npz") and os.path.exists(path_or_prefix):
        return load_params(path_or_prefix)
    if os.path.exists(path_or_prefix + ".npz"):
        return load_params(path_or_prefix + ".npz")
    if os.path.exists(path_or_prefix + ".index"):
        from clair3_rna_torch.models.convert import params_from_tf_checkpoint
        return params_from_tf_checkpoint(path_or_prefix,
                                         add_indel_length=add_indel_length)
    raise FileNotFoundError(f"no model weights at {path_or_prefix}")
