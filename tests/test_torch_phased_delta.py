"""tools/torch_phased_delta.py at its quick size on the CPU, held to the
JAX package: the 18- and 30-channel models trained with the port's
tensor2bin and train, the unphased and the phased calls scored against
the planted variants, the delta recorded. (The quick models train for 2
epochs on reads with 1% errors, so the F1 values themselves say little;
the card's run at the tool's defaults does.)

Inside the tool's run, while its work directory exists, the JAX side
repeats each step on what the port wrote: the dataset from
tools/phased_delta.py's recipe (tests/simdata.py, seed 4242) must be the
same bytes; the JAX package's `call`, `phase_bam` and `call
--enable_phasing_model`, given the port's trained weights, must write the
port's VCF bodies and tagged BAM; and tools/phased_delta.py's scoring of
its own calls must give the port's F1 values."""

import json
import os
import random
import sys

import torch

# one intra-op thread: the suite runs six worker processes on a
# shared host, where PyTorch's spinning thread pools oversubscribe it
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (REPO, os.path.join(REPO, "tools")):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _body(path):
    with open(path) as f:
        return [line for line in f if not line.startswith("#")]


def _jax_side(d, run, contig_len, n_variants, depth, error_rate):
    """tools/phased_delta.py's steps through the JAX package, on the
    port's weights, in d/jax: what agrees with the port's run."""
    import phased_delta
    from tests import simdata
    from clair3_rna_tpu.cli import main as jcli
    from clair3_rna_tpu.io.fasta import write_fasta

    j = os.path.join(d, "jax")
    os.makedirs(j)
    rng = random.Random(4242)
    genome = simdata.random_genome(rng, [("chr1", contig_len)])
    variants = simdata.plant_variants(rng, genome, n_per_contig=n_variants,
                                      het_genotypes=((0, 1), (1, 0)))
    write_fasta(os.path.join(j, "ref.fa"), genome)
    simdata.simulate_bam(os.path.join(j, "reads.bam"), genome, variants, rng,
                         depth=depth, error_rate=error_rate)
    phased_delta.build_truth_vcf(os.path.join(j, "truth.vcf"), variants)
    for key, name in (("fasta", "ref.fa"), ("bam", "reads.bam"),
                      ("truth", "truth.vcf")):
        assert _bytes(run[key]) == _bytes(os.path.join(j, name)), name

    fasta, bam, truth = run["fasta"], run["bam"], run["truth"]
    jcli(["call", "-B", bam, "-R", fasta, "-o", os.path.join(j, "call18"),
          "--model_path", run["w18"], "--include_all_ctgs", "--no_compress"])
    unphased = os.path.join(j, "call18", "output.vcf")
    assert _body(unphased) and _body(unphased) == _body(run["unphased_vcf"])
    tagged = os.path.join(j, "tagged.bam")
    jcli(["phase_bam", "--bam_fn", bam, "--ref_fn", fasta, "--vcf_fn",
          unphased, "--output_bam_fn", tagged])
    # the quick model calls variants, so the phaser has reads to tag
    assert _bytes(tagged) == _bytes(run["tagged_bam"]) != _bytes(bam)
    jcli(["call", "-B", bam, "-R", fasta, "-o", os.path.join(j, "call30"),
          "--model_path", run["w18"], "--include_all_ctgs", "--no_compress",
          "--enable_phasing_model", "--phased_model_path", run["w30"]])
    phased = os.path.join(j, "call30", "output_enable_phasing.vcf")
    assert _body(phased) and _body(phased) == _body(run["phased_vcf"])
    return {"unphased": phased_delta.f1_of(unphased, truth),
            "phased": phased_delta.f1_of(phased, truth)}


def test_phased_delta_quick(tmp_path, monkeypatch):
    import torch_phased_delta
    real, jax_f1 = torch_phased_delta.experiment, {}

    def held_to_jax(d, contig_len, n_variants, depth, error_rate, *rest):
        run = real(d, contig_len, n_variants, depth, error_rate, *rest)
        jax_f1.update(_jax_side(d, run, contig_len, n_variants, depth,
                                error_rate))
        return run

    monkeypatch.setattr(torch_phased_delta, "experiment", held_to_jax)
    res = torch_phased_delta.main(["--quick", "--device", "cpu",
                                   "--data-dir", str(tmp_path)])
    keys = {"overall", "snv", "ins", "del"}
    assert set(res["unphased"]) == set(res["phased"]) == keys
    assert jax_f1 == {"unphased": res["unphased"], "phased": res["phased"]}
    for k in keys:
        assert 0.0 <= res["unphased"][k] <= 1.0
        assert 0.0 <= res["phased"][k] <= 1.0
        assert res["delta"][k] == res["phased"][k] - res["unphased"][k]
    with open(tmp_path / "torch_phased_delta_quick.json") as f:
        assert json.load(f)["dataset"]["seed"] == 4242
    # the temporary work directory is gone; only the artifact stays
    assert os.listdir(tmp_path) == ["torch_phased_delta_quick.json"]
