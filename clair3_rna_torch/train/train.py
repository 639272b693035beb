"""Training loop: RAdam + focal loss, on one device or a device mesh.

Matches the reference's training recipe (shared/param_p.py:8-9,49-57: Radam
optimizer, FocalLoss, batch 2000, lr 1e-3, L2 1e-7, 90/10 split, 30 epochs)
and the JAX package's train_model step for step: the same RandomState(seed)
split and per-epoch permutations (so the same batches reach the step), the
same batch clamp, validation in batches and early stop. The weights start
from this package's init_params(seed), which differs from the JAX
package's init for the same seed; dropout masks come from a
torch.Generator seeded with `seed` on the run's device.

Each step is one unslabbed pass over the batch (models/network.py): a
2,000-row batch on a card would otherwise pad to one 4,096-row inference
slab and compute twice the rows; the loss is the same either way, since a
row's probabilities do not depend on the rows beside it beyond float32
rounding.
"""

import copy
import logging

import numpy as np
import torch

from clair3_rna_torch import config, resolve_device
from clair3_rna_torch.parallel.mesh import (ShardedNet, shard_params,
                                            sharded_train_step_fn, task_loss,
                                            train_step_fn)

logger = logging.getLogger(__name__)


def train_model(bin_dir, output_path, *, add_indel_length=True, phased=False,
                batch_size=config.TRAIN_BATCH_SIZE,
                learning_rate=config.INITIAL_LEARNING_RATE,
                max_epochs=config.MAX_EPOCH, seed=0,
                validation_fraction=1 - config.TRAINING_DATASET_PERCENTAGE,
                patience=5, use_mesh=True, device=None):
    """Train PileupNet on binned tensors on `device` (CUDA unless "cpu");
    saves the best weights to .npz (the JAX package's layout). With
    use_mesh and more than one card, steps run sharded over the driver's
    default mesh. Returns (path, best validation loss)."""
    from clair3_rna_torch.caller.driver import default_mesh
    from clair3_rna_torch.models.network import init_params
    from clair3_rna_torch.models.params_io import save_params
    from clair3_rna_torch.train.data import load_bins
    from clair3_rna_torch.train.radam import RAdam

    device = resolve_device(device)
    X, Y = load_bins(bin_dir)
    expected_channels = config.CHANNEL_SIZE + (
        config.PHASED_CHANNEL_SIZE if phased else 0)
    if X.shape[-1] != expected_channels:
        raise SystemExit(
            f"[ERROR] bins have {X.shape[-1]} channels but "
            f"{'--phased' if phased else 'unphased'} training expects "
            f"{expected_channels} (rebuild with tensor2bin "
            f"{'--phased' if phased else 'without --phased'})")
    n = len(X)
    rng = np.random.RandomState(seed)
    order = rng.permutation(n)
    X, Y = X[order], Y[order]
    n_val = max(1, int(n * validation_fraction))
    X_train, Y_train = X[n_val:], Y[n_val:]
    X_val, Y_val = X[:n_val], Y[:n_val]
    if not add_indel_length:
        Y_train = Y_train[:, :24]
        Y_val = Y_val[:, :24]
    logger.info("[INFO] training on %d samples, validating on %d",
                len(X_train), n_val)

    mesh = default_mesh(tp=1, device=device) if use_mesh else None
    n_dev = mesh.shape["dp"] if mesh is not None else 1
    # clamp to the training set so small datasets still take gradient steps
    # (the step loop drops partial batches to keep the step shape fixed)
    batch_size = min(batch_size, len(X_train))
    batch_size = max(n_dev, batch_size - batch_size % n_dev)
    optimizer = RAdam(learning_rate)
    params = init_params(seed, add_indel_length=add_indel_length,
                         phased=phased, device=device)
    params.requires_grad_(True).train()
    if mesh is not None:
        params = shard_params(params, mesh).requires_grad_(True)
        train_step = sharded_train_step_fn(None, optimizer, mesh,
                                           add_indel_length=add_indel_length)
        logger.info("[INFO] device mesh: dp=%d tp=%d", mesh.shape["dp"],
                    mesh.shape["tp"])
    else:
        train_step = train_step_fn(optimizer,
                                   add_indel_length=add_indel_length)
    opt_state = optimizer.init(params.parameters())
    generator = torch.Generator(device=params.device).manual_seed(int(seed))

    def eval_loss(x, y):
        with torch.inference_mode():
            x = torch.from_numpy(x).to(params.device, torch.float32)
            y = torch.from_numpy(y).to(params.device, torch.float32)
            return task_loss(params(x), y, add_indel_length)

    best_val = float("inf")
    best_params = _snapshot(params)
    bad_epochs = 0
    steps_per_epoch = max(1, len(X_train) // batch_size)
    if steps_per_epoch < 8:
        logger.warning(
            "[WARNING] only %d optimizer step(s) per epoch (batch %d vs "
            "%d samples): with few total steps the model will undertrain; "
            "lower --batch_size for small datasets",
            steps_per_epoch, batch_size, len(X_train))
    for epoch in range(max_epochs):
        perm = rng.permutation(len(X_train))
        epoch_loss = 0.0
        for step in range(steps_per_epoch):
            idx = perm[step * batch_size:(step + 1) * batch_size]
            if len(idx) < batch_size:
                continue
            params, opt_state, loss = train_step(
                params, opt_state, X_train[idx], Y_train[idx], generator)
            epoch_loss += float(loss)
        val = _batched_eval(eval_loss, X_val, Y_val, batch_size)
        logger.info("[INFO] epoch %d: train loss %.4f, val loss %.4f",
                    epoch + 1, epoch_loss / steps_per_epoch, val)
        if val < best_val - 1e-5:
            best_val = val
            best_params = _snapshot(params)
            bad_epochs = 0
        else:
            bad_epochs += 1
            if bad_epochs >= patience:
                logger.info("[INFO] early stop at epoch %d", epoch + 1)
                break

    path = save_params(output_path, best_params)
    logger.info("[INFO] saved weights -> %s (val loss %.4f)", path, best_val)
    return path, best_val


def _snapshot(params):
    """A detached PileupNet copy of the current weights (gathered from a
    ShardedNet)."""
    if isinstance(params, ShardedNet):
        return params.unshard()
    return copy.deepcopy(params).requires_grad_(False).eval()


def _batched_eval(eval_loss, X, Y, batch_size):
    total, count = 0.0, 0
    for lo in range(0, len(X), batch_size):
        x = X[lo:lo + batch_size]
        y = Y[lo:lo + batch_size]
        if len(x) == 0:
            continue
        total += float(eval_loss(x, y)) * len(x)
        count += len(x)
    return total / max(1, count)
