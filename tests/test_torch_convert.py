"""The port's TF-checkpoint conversion (clair3_rna_torch/models/convert.py)
against the JAX package's.

The released Clair3-RNA models ship as TF checkpoints, so conversion is the
only way to call with them. Synthetic full-width weights (LSTM 128/160
units, L4 over 33 x 320 inputs), named in both Keras schemes the converter
accepts and in creation order under natural-key sort (L4 before the
heads), go through both packages' params_from_named_weights: the trees
must be equal array for array, and the port's forward within 1e-5 of the
JAX forward. Where TensorFlow imports, the same variables are written as
a tf.train.Checkpoint: both packages' params_from_tf_checkpoint must give
that tree, and the port's `call --model_path <prefix> --device cpu` must
write the JAX package's body.

The JAX package is imported inside the tests, so this file still collects
where JAX is absent."""

import os
import random

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs six worker processes on a
# shared host, where PyTorch's spinning thread pools oversubscribe it
torch.set_num_threads(1)

WINDOW, CHANNELS = 33, 18


def _layers(add_indel_length):
    """(tree key, kernel shape) of the dense layers in the model's
    creation order."""
    heads = [("l4", (WINDOW * 320, 128)), ("gt21_dense", (128, 128)),
             ("genotype_dense", (128, 128))]
    if add_indel_length:
        heads += [("length1_dense", (128, 128)), ("length2_dense", (128, 128))]
    heads += [("gt21_logits", (128, 21)), ("genotype_logits", (128, 3))]
    if add_indel_length:
        heads += [("length1_logits", (128, 33)), ("length2_logits", (128, 33))]
    return heads


def _named_weights(scheme, add_indel_length, seed=0):
    """({variable name: array}, the PileupNet tree they must convert to)."""
    rng = np.random.default_rng(seed)

    def arr(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)

    named, tree = {}, {}
    for i, (layer, units, fan_in) in enumerate(
            (("lstm1", 128, CHANNELS), ("lstm2", 160, 256))):
        tree[layer] = {}
        for direction in ("forward", "backward"):
            if scheme == "keras2":
                base = f"LSTM{i + 1}/{direction}_layer/lstm_cell"
            else:
                suffix = f"_{i}" if i else ""
                base = (f"bidirectional{suffix}/{direction}_lstm{suffix}"
                        "/lstm_cell")
            leaf = {"kernel": arr(fan_in, 4 * units),
                    "recurrent_kernel": arr(units, 4 * units),
                    "bias": arr(4 * units)}
            tree[layer][direction] = leaf
            for kind, a in leaf.items():
                named[f"{base}/{kind}"] = a
    for j, (name, shape) in enumerate(_layers(add_indel_length)):
        leaf = {"kernel": arr(*shape), "bias": arr(shape[1])}
        tree[name] = leaf
        if scheme == "keras2":
            if name == "l4":
                base = "L4"
            elif name.endswith("_dense"):
                base = f"L5_{j}"
            else:
                base = f"L6_{j}"
        else:
            base = "dense" + (f"_{j}" if j else "")
        for kind, a in leaf.items():
            named[f"{base}/{kind}"] = a
    return named, tree


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, p) if isinstance(v, dict) else {p: np.asarray(v)})
    return out


def _assert_same_tree(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def jax_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: jax_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


CASES = [(s, ind) for s in ("keras2", "keras3") for ind in (False, True)]


@pytest.mark.parametrize("scheme,add_indel_length", CASES)
def test_named_weights_match_jax(scheme, add_indel_length):
    """Both packages' params_from_named_weights give the tree the names
    were drawn from, exactly; the port's forward on it is within 1e-5 of
    the JAX package's on 64 windows."""
    from clair3_rna_torch.models import convert as tconv
    from clair3_rna_torch.models.network import make_forward_fn
    from clair3_rna_torch.models.params_io import params_from_numpy
    from clair3_rna_tpu.models import convert as jconv
    from clair3_rna_tpu.models.network import make_forward_fn as jmake

    named, tree = _named_weights(scheme, add_indel_length)
    # the converter must not depend on the order names arrive in
    port = tconv.params_from_named_weights(
        dict(reversed(list(named.items()))), add_indel_length=add_indel_length)
    jtree = jconv.params_from_named_weights(
        named, add_indel_length=add_indel_length)
    _assert_same_tree(port, tree)
    _assert_same_tree(jax_to_numpy(jtree), port)

    x = np.random.default_rng(9).integers(
        -40, 40, (64, WINDOW, CHANNELS)).astype(np.int32)
    _, tfwd = make_forward_fn(add_indel_length=add_indel_length)
    _, jfwd = jmake(add_indel_length=add_indel_length)
    got = tfwd(params_from_numpy(port, device="cpu"), x).numpy()
    want = np.asarray(jfwd(jtree, x))
    assert got.shape == want.shape == (64, 24 + 66 * add_indel_length)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_converter_rejects_incomplete_weights():
    """A missing LSTM leaf or head raises in both packages alike."""
    from clair3_rna_torch.models import convert as tconv
    from clair3_rna_tpu.models import convert as jconv

    named, _ = _named_weights("keras2", False)
    for drop in ("LSTM2/backward_layer/lstm_cell/bias", "L6_4/kernel"):
        part = {k: v for k, v in named.items() if k != drop}
        for conv in (tconv, jconv):
            with pytest.raises(ValueError):
                conv.params_from_named_weights(part)


def _write_checkpoint(tf, named, prefix):
    """The variables as a TF-format object checkpoint (.index/.data, the
    layout of the released models): nested tf.Modules along each name."""
    root = tf.Module()
    for name, a in named.items():
        node = root
        *parents, leaf = name.split("/")
        for part in parents:
            if not hasattr(node, part):
                setattr(node, part, tf.Module())
            node = getattr(node, part)
        setattr(node, leaf, tf.Variable(a))
    tf.train.Checkpoint(model=root).write(prefix)


@pytest.mark.parametrize("scheme,add_indel_length",
                         [("keras2", True), ("keras3", False)])
def test_tf_checkpoint_matches_jax(tmp_path, scheme, add_indel_length):
    """Both packages read the checkpoint to the same tree."""
    tf = pytest.importorskip("tensorflow")
    from clair3_rna_torch.models import convert as tconv
    from clair3_rna_tpu.models import convert as jconv

    named, tree = _named_weights(scheme, add_indel_length, seed=4)
    prefix = str(tmp_path / "variables" / "variables")
    _write_checkpoint(tf, named, prefix)
    port = tconv.params_from_tf_checkpoint(
        prefix, add_indel_length=add_indel_length)
    _assert_same_tree(port, tree)
    _assert_same_tree(jax_to_numpy(jconv.params_from_tf_checkpoint(
        prefix, add_indel_length=add_indel_length)), port)


def test_call_with_tf_checkpoint_matches_jax(tmp_path):
    """`call --model_path <checkpoint prefix>`: the port (on the CPU) and
    the JAX package write the same body on a tests/simdata.py dataset."""
    tf = pytest.importorskip("tensorflow")
    from tests import simdata
    from clair3_rna_tpu.io.fasta import write_fasta
    from clair3_rna_torch.cli import main as tmain
    from clair3_rna_tpu.cli import main as jmain

    named, _ = _named_weights("keras2", False, seed=6)
    prefix = str(tmp_path / "ckpt" / "variables")
    _write_checkpoint(tf, named, prefix)
    rng = random.Random(23)
    genome = simdata.random_genome(rng, [("chr1", 9000)])
    variants = simdata.plant_variants(rng, genome, n_per_contig=30)
    fasta, bam = str(tmp_path / "ref.fa"), str(tmp_path / "reads.bam")
    write_fasta(fasta, genome)
    simdata.simulate_bam(bam, genome, variants, rng, depth=25)

    bodies = {}
    for name, main, extra in (("port", tmain, ["--device", "cpu"]),
                              ("jax", jmain, [])):
        out = str(tmp_path / name)
        main(["call", "-B", bam, "-R", fasta, "-o", out, "--model_path",
              prefix, "--no_compress", *extra])
        bodies[name] = [line for line in open(os.path.join(out, "output.vcf"))
                        if not line.startswith("#")]
    assert bodies["port"] and bodies["port"] == bodies["jax"]
