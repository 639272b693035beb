"""Training on the PyTorch port against the JAX package.

- tensor2bin: the port's bins equal the JAX package's byte for byte
  (position_matrix, label, position, alt_info, shard count);
- the RAdam step equals optax.radam's jitted update (the JAX package runs
  it inside its jitted train step) over 10 steps of identical random
  gradients, each array within 1e-6 of its largest element (XLA contracts
  the moment updates into FMAs, so an element near cancellation may differ
  by a few ulps of its summands);
- from the JAX package's init_params(0) carried across as numpy, with
  dropout off on both sides and the same batches, the port's train step
  gives the JAX step's losses within relative 1e-5 for 8 steps and its
  weights within 1e-5 through step 5 (the JAX step is built here from its
  own task_loss, l2_regularization, model.apply(train=False) and
  optax.radam);
- a mesh step (4 repeated CPU devices, dp 2 x tp 2) equals the plain step:
  loss within relative 1e-6, weights within 1e-6, with the same dropout
  masks from the same generator;
- dropout: rate, 1/(1-p) scaling, the same masks from the same generator,
  and inference untouched by it;
- the learning loop recovers planted variants (F1 > 0.6) and its weights
  load in the JAX package, whose probabilities are within 1e-5; the
  30-channel (phased) bins and model through the CLI.
"""

import os

import numpy as np
import pytest
import torch

from clair3_rna_torch import config
from clair3_rna_torch.models import network as tnet
from clair3_rna_torch.models.params_io import (load_params,
                                               params_from_numpy,
                                               params_to_numpy)
from clair3_rna_torch.parallel.mesh import (make_mesh, shard_params,
                                            sharded_train_step_fn,
                                            train_step_fn)
from clair3_rna_torch.train.radam import RAdam

# one intra-op thread: the suite runs six worker processes on a
# shared host, where PyTorch's spinning thread pools oversubscribe it
torch.set_num_threads(1)


def _write_truth(path, variants):
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER"
                "\tINFO\tFORMAT\tS\n")
        for v in variants["chr1"]:
            gt = "1/1" if v.genotype == (1, 1) else "0/1"
            f.write(f"chr1\t{v.pos + 1}\t.\t{v.ref}\t{v.alt}\t60\tPASS\t.\t"
                    f"GT\t{gt}\n")


def _batch(rng, n, channels=18):
    """Random windows and one-hot labels of the four heads."""
    x = rng.randint(-30, 30, (n, 33, channels)).astype(np.int32)
    y = np.zeros((n, config.LABEL_SIZE), np.float32)
    rows = np.arange(n)
    y[rows, rng.randint(0, 21, n)] = 1
    y[rows, 21 + rng.randint(0, 3, n)] = 1
    y[rows, 24 + rng.randint(0, 33, n)] = 1
    y[rows, 57 + rng.randint(0, 33, n)] = 1
    return x, y


def _flat(net):
    return {k: v.detach().cpu().numpy() for k, v in net.state_dict().items()}


def test_tensor2bin_bins_equal_jax(tmp_path):
    from clair3_rna_tpu.config import PileupConfig as JCfg
    from clair3_rna_tpu.train.data import build_training_bins as jbuild

    from clair3_rna_torch import simdata
    from clair3_rna_torch.config import PileupConfig
    from clair3_rna_torch.train.data import build_training_bins

    fasta, bam, _, variants = simdata.make_dataset(
        tmp_path, seed=99, contig_len=12000, n_variants=30, depth=30)
    truth = str(tmp_path / "truth.vcf")
    _write_truth(truth, variants)
    kw = dict(non_variant_keep_fraction=0.5, shard_size=60, seed=3,
              chunk_size=5000)
    want = jbuild(bam, fasta, truth, str(tmp_path / "jax"),
                  cfg=JCfg(batch_size=256), **kw)
    got = build_training_bins(bam, fasta, truth, str(tmp_path / "port"),
                              cfg=PileupConfig(batch_size=256),
                              device="cpu", **kw)
    assert got == want and want[0] >= 2, (got, want)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    for name in names:
        a = np.load(tmp_path / "jax" / name)
        b = np.load(tmp_path / "port" / name)
        for key in ("position_matrix", "label", "position", "alt_info"):
            assert a[key].dtype == b[key].dtype, key
            assert a[key].tobytes() == b[key].tobytes(), (name, key)


def test_radam_matches_optax():
    import jax
    import jax.numpy as jnp
    import optax

    rng = np.random.default_rng(0)
    shapes = [(7, 5), (13,), (3, 4, 2), (300, 64)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    opt = optax.radam(1e-3)
    update = jax.jit(opt.update)
    state = opt.init([jnp.asarray(p) for p in params])
    radam = RAdam(1e-3)
    tstate = radam.init([torch.from_numpy(p) for p in params])
    for step in range(10):
        grads = [(rng.standard_normal(s)
                  * 10.0 ** rng.integers(-4, 2)).astype(np.float32)
                 for s in shapes]
        want, state = update([jnp.asarray(g) for g in grads], state)
        got, tstate = radam.update([torch.from_numpy(g) for g in grads],
                                   tstate)
        for a, b in zip(want, got):
            a = np.asarray(a)
            err = np.abs(a - b.numpy()).max() / np.abs(a).max()
            assert err <= 1e-6, (step + 1, err)
    assert tstate.count == 10


def test_train_step_parity_with_jax():
    import jax
    import jax.numpy as jnp
    import optax

    from clair3_rna_tpu.models.network import PileupNet, init_params
    from clair3_rna_tpu.parallel.mesh import l2_regularization, task_loss

    jparams = init_params(0, add_indel_length=True)
    net = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                            device="cpu").requires_grad_(True).train()
    model = PileupNet(add_indel_length=True)
    jopt = optax.radam(1e-3)

    def loss_fn(p, x, y):
        probs = model.apply({"params": p}, x, train=False)
        return task_loss(probs, y, True) + l2_regularization(p)

    @jax.jit
    def jstep(p, s, x, y):
        loss, grads = jax.value_and_grad(loss_fn)(p, x, y)
        updates, s = jopt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss

    jstate = jopt.init(jparams)
    radam = RAdam(1e-3)
    tstate = radam.init(net.parameters())
    tstep = train_step_fn(radam, add_indel_length=True)
    rng = np.random.RandomState(1)
    for step in range(1, 9):
        x, y = _batch(rng, 32)
        jparams, jstate, jloss = jstep(jparams, jstate, jnp.asarray(x),
                                       jnp.asarray(y))
        net, tstate, tloss = tstep(net, tstate, x, y, None)
        assert abs(float(tloss) - float(jloss)) <= 1e-5 * abs(float(jloss))
        if step <= 5:
            want = jax.tree_util.tree_leaves(
                jax.tree_util.tree_map(np.asarray, jparams))
            got = jax.tree_util.tree_leaves(params_to_numpy(net))
            assert len(want) == len(got)
            for a, b in zip(want, got):
                np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dropout", [False, True])
def test_mesh_train_step_equals_plain(dropout):
    base = tnet.init_params(4, device="cpu")
    plain = tnet.init_params(4, device="cpu").requires_grad_(True)
    mesh = make_mesh(devices=[torch.device("cpu")] * 4, tp=2)
    sharded = shard_params(base, mesh).requires_grad_(True)
    opt_p, opt_s = RAdam(1e-3), RAdam(1e-3)
    st_p, st_s = opt_p.init(plain.parameters()), opt_s.init(
        sharded.parameters())
    step_p = train_step_fn(opt_p)
    step_s = sharded_train_step_fn(None, opt_s, mesh)
    rng = np.random.RandomState(2)
    for _ in range(2):
        x, y = _batch(rng, 24)
        y = y[:, :24]
        gp = torch.Generator().manual_seed(7) if dropout else None
        gs = torch.Generator().manual_seed(7) if dropout else None
        plain, st_p, lp = step_p(plain, st_p, x, y, gp)
        sharded, st_s, ls = step_s(sharded, st_s, x, y, gs)
        assert abs(float(lp) - float(ls)) <= 1e-6 * abs(float(lp))
    got, want = _flat(sharded.unshard()), _flat(plain)
    moved = max(np.abs(want[k] - _flat(base)[k]).max() for k in want)
    assert moved > 1e-5  # the steps changed the weights
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    # every dp row's replicas and pieces carry the same updated weights
    for name in sharded.names:
        for row in sharded.rows[1:]:
            for a, b in zip(row[name], sharded.rows[0][name]):
                assert torch.equal(a, b), name


def test_dropout_rate_scaling_and_determinism():
    net = tnet.init_params(5, device="cpu")
    masks = net.dropout_masks(4000, torch.Generator().manual_seed(3))
    assert len(masks) == 2 + len(net.head_names)
    keep = [float(m.float().mean()) for m in masks]
    assert abs(keep[0] - 0.8) < 0.005 and abs(keep[1] - 0.5) < 0.01
    assert all(abs(k - 0.8) < 0.01 for k in keep[2:])
    again = net.dropout_masks(4000, torch.Generator().manual_seed(3))
    assert all(torch.equal(a, b) for a, b in zip(masks, again))
    other = net.dropout_masks(4000, torch.Generator().manual_seed(4))
    assert not torch.equal(masks[0], other[0])

    x = torch.arange(12.0).reshape(3, 4) + 1
    keep = torch.tensor([[True, False, True, True]] * 3)
    out = tnet._dropout(x, keep, 0.5)
    assert torch.equal(out, torch.where(keep, x / 0.5, 0.0))

    rng = np.random.RandomState(0)
    xb = torch.from_numpy(rng.randint(-30, 30, (10, 33, 18))
                          .astype(np.float32))
    with torch.no_grad():
        a = net(xb, train=True, generator=torch.Generator().manual_seed(9))
        b = net(xb, train=True, generator=torch.Generator().manual_seed(9))
        c = net(xb, train=True, generator=torch.Generator().manual_seed(8))
        undropped = net(xb, train=True)
        inference = net(xb)
    assert torch.equal(a, b) and not torch.equal(a, c)
    # inference takes no mask, and is the default forward's result exactly
    assert torch.equal(inference, net.forward_slabs(xb))
    np.testing.assert_allclose(undropped.numpy(), inference.numpy(),
                               rtol=0, atol=1e-6)


def test_train_and_call_recovers_variants(tmp_path):
    import jax

    from clair3_rna_tpu.models.network import make_forward_fn as jforward
    from clair3_rna_tpu.models.params_io import load_params as jload

    from clair3_rna_torch import simdata
    from clair3_rna_torch.caller.decode import CallConfig
    from clair3_rna_torch.caller.pipeline import run_calling
    from clair3_rna_torch.config import PileupConfig
    from clair3_rna_torch.evaluation.compare_vcf import compare_vcf
    from clair3_rna_torch.train.data import build_training_bins, load_bins
    from clair3_rna_torch.train.train import train_model

    fasta, bam, _, variants = simdata.make_dataset(
        tmp_path, seed=99, contig_len=30000, n_variants=60, depth=40)
    truth = str(tmp_path / "truth.vcf")
    _write_truth(truth, variants)
    bin_dir = str(tmp_path / "bins")
    cfg = PileupConfig(batch_size=256)
    n_shards, n_var, n_nonvar = build_training_bins(
        bam, fasta, truth, bin_dir, cfg=cfg, non_variant_keep_fraction=0.6,
        min_truth_support=2, device="cpu")
    assert n_shards >= 1 and n_var >= 30, (n_shards, n_var, n_nonvar)
    X, Y = load_bins(bin_dir)
    assert X.shape[1:] == (33, 18) and Y.shape[1] == 90
    assert np.all(Y.sum(axis=1) == 4)  # four one-hot heads

    path, best_val = train_model(
        bin_dir, str(tmp_path / "model.npz"), add_indel_length=False,
        batch_size=128, max_epochs=12, patience=12,
        validation_fraction=0.15, device="cpu")
    assert os.path.exists(path) and np.isfinite(best_val)

    net = params_from_numpy(load_params(path), device="cpu")
    outputs, _ = run_calling(
        bam, fasta, str(tmp_path / "out.vcf"), cfg=cfg,
        call_cfg=CallConfig(show_ref=False), params=net, compress=False,
        progress=False, pileup_backend="host")
    result = compare_vcf(outputs[0], truth, skip_genotyping=True)
    # overfit on its own training region: must recover most planted variants
    assert result.overall.f1 > 0.6, result.overall.row("overall")

    # the saved weights load in the JAX package and give its probabilities
    _, fwd = jforward(add_indel_length=False)
    want = np.asarray(fwd(jload(path), X[:64]))
    _, tfwd = tnet.make_forward_fn()
    np.testing.assert_allclose(tfwd(net, X[:64]).numpy(), want, rtol=0,
                               atol=1e-5)
    assert sorted(jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(np.shape, jload(path)))) == sorted(
        jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(np.shape, load_params(path))))


def test_train_batch_larger_than_dataset_still_learns(tmp_path):
    """With batch_size > n_samples the loop must clamp the batch and take
    steps, not save the initial weights."""
    from clair3_rna_torch.train.train import train_model

    rng = np.random.RandomState(0)
    n = 60
    X = rng.randint(-20, 20, size=(n, 33, 18)).astype(np.int32)
    Y = np.zeros((n, 90), np.float32)
    Y[:, 0] = 1.0
    Y[:, 21] = 1.0
    Y[:, 24 + 16] = 1.0
    Y[:, 57 + 16] = 1.0
    bin_dir = tmp_path / "bins"
    bin_dir.mkdir()
    np.savez_compressed(
        bin_dir / "bin_00000.npz", position_matrix=X, label=Y,
        position=np.arange(n), alt_info=np.array(["5-"] * n))
    out = str(tmp_path / "w.npz")
    train_model(str(bin_dir), out, add_indel_length=False, batch_size=2000,
                max_epochs=2, use_mesh=False, device="cpu")
    trained = _flat(params_from_numpy(load_params(out), device="cpu"))
    init = _flat(tnet.init_params(0, device="cpu"))
    assert any(np.abs(trained[k] - init[k]).max() > 1e-7 for k in init), \
        "weights unchanged from init: no training step ran"


def test_train_model_on_a_mesh_equals_plain(tmp_path, monkeypatch):
    """train_model on a mesh of 4 repeated CPU devices (dp 2 x tp 2, in
    place of the driver's mesh of the cards) saves the plain run's
    weights: same batches, same dropout masks."""
    from clair3_rna_torch.caller import driver
    from clair3_rna_torch.train.train import train_model

    rng = np.random.RandomState(5)
    x, y = _batch(rng, 80)
    bin_dir = tmp_path / "bins"
    bin_dir.mkdir()
    np.savez_compressed(bin_dir / "bin_00000.npz", position_matrix=x,
                        label=y, position=np.arange(80),
                        alt_info=np.array(["5-"] * 80))
    kw = dict(add_indel_length=False, batch_size=16, max_epochs=2,
              device="cpu")
    _, val_plain = train_model(str(bin_dir), str(tmp_path / "plain.npz"),
                               use_mesh=False, **kw)
    monkeypatch.setattr(driver, "default_mesh", lambda tp, device: make_mesh(
        devices=[torch.device("cpu")] * 4, tp=2))
    _, val_mesh = train_model(str(bin_dir), str(tmp_path / "mesh.npz"),
                              **kw)
    assert abs(val_mesh - val_plain) <= 1e-5 * val_plain
    want, got = (_flat(params_from_numpy(load_params(
        str(tmp_path / f"{name}.npz")), device="cpu"))
        for name in ("plain", "mesh"))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)


def test_phased_tensor2bin_and_train(tmp_path):
    from clair3_rna_torch import simdata
    from clair3_rna_torch.cli import main

    fasta, bam, _, variants = simdata.make_dataset(
        tmp_path, seed=71, contig_len=9000, n_variants=20, depth=30,
        with_hp=True)
    truth = str(tmp_path / "truth.vcf")
    _write_truth(truth, variants)

    bins = str(tmp_path / "bins")
    main(["tensor2bin", "--bam_fn", bam, "--ref_fn", fasta,
          "--truth_vcf_fn", truth, "--output_dir", bins, "--phased",
          "--non_variant_keep_fraction", "1.0", "--device", "cpu"])
    data = np.load(os.path.join(bins, sorted(os.listdir(bins))[0]))
    assert data["position_matrix"].shape[-1] == 30, "phased bins must be 30ch"
    # HP channels must actually carry counts (the BAM is haplotagged)
    assert np.abs(data["position_matrix"][..., 18:]).sum() > 0

    weights = str(tmp_path / "phased.npz")
    main(["train", "--bin_dir", bins, "--output_fn", weights, "--phased",
          "--no_indel_length", "--batch_size", "16", "--max_epochs", "2",
          "--device", "cpu"])
    net = params_from_numpy(load_params(weights), device="cpu")
    _, fwd = tnet.make_forward_fn()
    probs = fwd(net, data["position_matrix"][:4]).numpy()
    assert probs.shape == (4, 24), "trained phased model must accept 30ch"

    # channel-mismatch guard: unphased training on phased bins errors clearly
    with pytest.raises(SystemExit, match="30 channels"):
        main(["train", "--bin_dir", bins, "--output_fn",
              str(tmp_path / "x.npz"), "--no_indel_length", "--device",
              "cpu"])


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tree = params_to_numpy(tnet.init_params(6, device="cpu"))
    nets = {d: params_from_numpy(tree, device=d).requires_grad_(True)
            for d in ("cpu", "cuda")}
    opts = {d: RAdam(1e-3) for d in nets}
    states = {d: opts[d].init(nets[d].parameters()) for d in nets}
    steps = {d: train_step_fn(opts[d]) for d in nets}
    rng = np.random.RandomState(3)
    for _ in range(3):
        x, y = _batch(rng, 200)
        losses = {}
        for d in nets:
            nets[d], states[d], loss = steps[d](nets[d], states[d], x,
                                                y[:, :24], None)
            losses[d] = float(loss)
        assert abs(losses["cuda"] - losses["cpu"]) <= 1e-5 * losses["cpu"]
    got, want = _flat(nets["cuda"]), _flat(nets["cpu"])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5)
