"""Reference (TF/Keras) checkpoint -> PileupNet parameter tree (numpy).

The reference ships TF-format checkpoints per platform
(run_clair3_rna:488-495, loaded at clair3_rna/call_variants.py:1472). Kernel
layouts are identical between Keras LSTM/Dense and PileupNet (gate
order i,f,g,o; kernel [in, out]), so conversion is pure name/shape
classification, robust to both Keras attribute paths (LSTM1/forward_layer/...)
and Keras 3 auto-names (bidirectional/forward_lstm/...).
"""

import re

import numpy as np

LSTM1_UNITS = 128
LSTM2_UNITS = 160


def _natural_key(name):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", name)]


def _classify_lstm(name, shape):
    """Return (layer, direction, kind) for an LSTM weight, or None."""
    dims = tuple(shape)
    if len(dims) == 2 and dims[1] == 4 * LSTM1_UNITS:
        layer = "lstm1"
        kind = "recurrent_kernel" if "recurrent" in name else "kernel"
    elif len(dims) == 2 and dims[1] == 4 * LSTM2_UNITS:
        layer = "lstm2"
        kind = "recurrent_kernel" if "recurrent" in name else "kernel"
    elif len(dims) == 1 and dims[0] == 4 * LSTM1_UNITS:
        layer, kind = "lstm1", "bias"
    elif len(dims) == 1 and dims[0] == 4 * LSTM2_UNITS:
        layer, kind = "lstm2", "bias"
    else:
        return None
    lowered = name.lower()
    if "backward" in lowered:
        direction = "backward"
    elif "forward" in lowered:
        direction = "forward"
    else:
        direction = None
    return layer, direction, kind


def params_from_named_weights(named_weights, add_indel_length=False):
    """Build a PileupNet numpy parameter tree from {variable_name: ndarray}
    (models/params_io.params_from_numpy makes the module).

    Accepts names from Keras model.weights, Keras 3 .h5 layout, or
    tf.train.load_checkpoint attribute paths.
    """
    named_weights = {
        name: np.asarray(arr) for name, arr in named_weights.items()
        if np.asarray(arr).dtype.kind == "f"
    }

    lstm = {("lstm1", "forward"): {}, ("lstm1", "backward"): {},
            ("lstm2", "forward"): {}, ("lstm2", "backward"): {}}
    dense_by_shape = {}
    lstm_unassigned = []

    for name in sorted(named_weights, key=_natural_key):
        arr = named_weights[name]
        got = _classify_lstm(name, arr.shape)
        if got is not None:
            layer, direction, kind = got
            if direction is None:
                lstm_unassigned.append((layer, kind, arr))
            else:
                lstm[(layer, direction)][kind] = arr
            continue
        if arr.ndim == 2:  # dense kernel
            dense_by_shape.setdefault(("kernel", arr.shape[1], arr.shape[0]), []).append(arr)
        elif arr.ndim == 1:
            dense_by_shape.setdefault(("bias", arr.shape[0]), []).append(arr)

    # direction-less LSTM weights: assume forward first (creation order)
    for layer, kind, arr in lstm_unassigned:
        target = (layer, "forward") if kind not in lstm[(layer, "forward")] else (layer, "backward")
        lstm[target][kind] = arr

    def lstm_params(layer):
        return {
            "forward": {k: v for k, v in lstm[(layer, "forward")].items()},
            "backward": {k: v for k, v in lstm[(layer, "backward")].items()},
        }

    def dense(out_dim, ordinal, n_expected, in_dim=None):
        kernels = [a for key, arrs in dense_by_shape.items() if key[0] == "kernel"
                   and key[1] == out_dim and (in_dim is None or key[2] == in_dim)
                   for a in arrs]
        biases = [a for key, arrs in dense_by_shape.items()
                  if key[0] == "bias" and key[1] == out_dim for a in arrs]
        if len(kernels) < n_expected or len(biases) < n_expected:
            raise ValueError(
                f"checkpoint missing dense weights (out={out_dim}): "
                f"{len(kernels)} kernels / {len(biases)} biases, need {n_expected}")
        return {"kernel": kernels[ordinal], "bias": biases[ordinal]}

    n_128_dense = 4 if add_indel_length else 2   # L5_1/2 (+ L5_3/4)
    n_33 = 2 if add_indel_length else 0

    # L4 is the only dense with large fan-in (33*320)
    l4_kernel = None
    for key, arrs in dense_by_shape.items():
        if key[0] == "kernel" and key[1] == 128 and key[2] > 1000:
            l4_kernel = arrs[0]
    if l4_kernel is None:
        raise ValueError("checkpoint missing L4 kernel")
    # L4 bias vs head biases: all 128-dim biases in creation order; L4 first
    biases_128 = [a for key, arrs in dense_by_shape.items()
                  if key[0] == "bias" and key[1] == 128 for a in arrs]
    head_kernels_128 = [a for key, arrs in dense_by_shape.items()
                        if key[0] == "kernel" and key[1] == 128 and key[2] == 128
                        for a in arrs]
    if len(biases_128) != 1 + n_128_dense or len(head_kernels_128) != n_128_dense:
        raise ValueError(
            f"unexpected 128-dense layout: {len(biases_128)} biases, "
            f"{len(head_kernels_128)} kernels")

    params = {
        "lstm1": lstm_params("lstm1"),
        "lstm2": lstm_params("lstm2"),
        "l4": {"kernel": l4_kernel, "bias": biases_128[0]},
        "gt21_dense": {"kernel": head_kernels_128[0], "bias": biases_128[1]},
        "genotype_dense": {"kernel": head_kernels_128[1], "bias": biases_128[2]},
        "gt21_logits": dense(21, 0, 1),
        "genotype_logits": dense(3, 0, 1),
    }
    if add_indel_length:
        params["length1_dense"] = {"kernel": head_kernels_128[2], "bias": biases_128[3]}
        params["length2_dense"] = {"kernel": head_kernels_128[3], "bias": biases_128[4]}
        params["length1_logits"] = dense(33, 0, 2)
        params["length2_logits"] = dense(33, 1, 2)

    for layer in ("lstm1", "lstm2"):
        for direction in ("forward", "backward"):
            have = params[layer][direction]
            for kind in ("kernel", "recurrent_kernel", "bias"):
                if kind not in have:
                    raise ValueError(f"checkpoint missing {layer}/{direction}/{kind}")

    return params


def params_from_keras_model(keras_model, add_indel_length=False):
    """Convert a live Keras Clair3_P instance (parity testing)."""
    named = {w.path if hasattr(w, "path") else w.name: w.numpy()
             for w in keras_model.weights}
    return params_from_named_weights(named, add_indel_length=add_indel_length)


def params_from_tf_checkpoint(prefix, add_indel_length=False):
    """Convert an on-disk TF-format checkpoint (the released model files)."""
    import tensorflow as tf
    reader = tf.train.load_checkpoint(prefix)
    named = {}
    for key, shape in reader.get_variable_to_shape_map().items():
        if "optimizer" in key.lower() or ".OPTIMIZER" in key:
            continue
        named[key] = reader.get_tensor(key)
    return params_from_named_weights(named, add_indel_length=add_indel_length)
