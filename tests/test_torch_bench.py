"""bench_torch.py against bench.py and the JAX package on the CPU: its
datasets are byte-identical to bench.py's _dataset for the same small
arguments (and its weight-training set to bench.py's), and its --quick main
configuration's VCF body equals the JAX package's host route
(clair3_rna_tpu.caller.pipeline.run_calling) on the same dataset and
weights. Every configuration of the quick run, with JAX blocked, is in
tests/test_torch_no_jax.py.

Both DATA_DIRs point into tmp_path, so nothing is written into the repo's
.bench_data/. The JAX package is imported inside the tests."""

import os
import random
import sys

import pytest
import torch

# one intra-op thread: the suite runs six worker processes on a
# shared host, where PyTorch's spinning thread pools oversubscribe it
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


# each of bench.py's four datasets at small arguments: its tag and depth,
# a short contig (the splice at its middle) and, for mixed_depth, islands
SMALL = {
    "main": ("main", 6_000, 35, 33, None),
    "high_depth": ("high_depth", 2_500, 260, 14, None),
    "sustained": ("sustained", 8_000, 35, 44, None),
    "mixed": ("mixed_depth", 6_000, 14, 33,
              {"chr1": [(1_000, 1_300, 246), (3_000, 3_300, 246),
                        (4_500, 4_800, 246)]}),
}


@pytest.mark.parametrize("key", sorted(SMALL))
def test_datasets_match_bench_py(tmp_path, monkeypatch, key):
    """bench_torch._dataset and bench._dataset write the same FASTA and
    BAM bytes for the same (small) arguments, and bench_torch's quick
    sizes keep each dataset's tag and depth."""
    import bench
    import bench_torch

    monkeypatch.setattr(bench, "DATA_DIR", str(tmp_path / "jax"))
    monkeypatch.setattr(bench_torch, "DATA_DIR", str(tmp_path / "port"))
    tag, contig_len, depth, n_variants, extra = SMALL[key]
    for sizes in (bench_torch.QUICK, bench_torch.FULL):
        assert (sizes[key][0], sizes[key][2]) == (tag, depth)
    want = bench._dataset(tag, contig_len, depth, n_variants,
                          extra_regions=extra)
    got = bench_torch._dataset(tag, contig_len, depth, n_variants,
                               extra_regions=extra)
    assert [os.path.relpath(p, tmp_path / "port") for p in got] == \
        [os.path.relpath(p, tmp_path / "jax") for p in want]
    for g, w in zip(got, want):
        assert _bytes(g) == _bytes(w)
    assert len(_bytes(got[1])) > 50_000


def test_training_set_matches_bench_py(tmp_path):
    """bench_torch's weight-training set is bench.py's (seed 777; FASTA,
    BAM and truth VCF written as bench.py:98-112 writes them)."""
    import bench_torch
    from tests import simdata
    from clair3_rna_tpu.io.fasta import write_fasta

    contig_len, depth, n_variants = 8_000, bench_torch.QUICK["train"][1], 24
    (tmp_path / "port").mkdir()
    got = bench_torch._training_set(str(tmp_path / "port"), contig_len,
                                    depth, n_variants)
    d = tmp_path / "jax"
    d.mkdir()
    rng = random.Random(777)
    genome = simdata.random_genome(rng, [("chr1", contig_len)])
    variants = simdata.plant_variants(rng, genome, n_per_contig=n_variants)
    write_fasta(str(d / "ref.fa"), genome)
    simdata.simulate_bam(str(d / "reads.bam"), genome, variants, rng,
                         depth=depth)
    with open(d / "truth.vcf", "w") as f:
        f.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
                "FILTER\tINFO\tFORMAT\tSAMPLE\n")
        for v in variants["chr1"]:
            gt = "1/1" if v.genotype == (1, 1) else "0/1"
            f.write(f"chr1\t{v.pos + 1}\t.\t{v.ref}\t{v.alt}\t60\tPASS"
                    f"\t.\tGT\t{gt}\n")
    for g, name in zip(got, ("ref.fa", "reads.bam", "truth.vcf")):
        assert _bytes(g) == _bytes(d / name), name


def test_main_config_body_matches_jax_host_route(tmp_path, monkeypatch):
    """The main configuration (bench_torch.timed_runs on the host route
    with the bench's trained weights, --quick size) writes the JAX
    package's host-route body for the same dataset and weights."""
    import bench_torch
    from clair3_rna_torch.caller.decode import CallConfig
    from clair3_rna_torch.config import PileupConfig
    from clair3_rna_torch.models.network import make_wire_forward_fn
    from clair3_rna_torch.models.params_io import params_from_numpy

    monkeypatch.setattr(bench_torch, "DATA_DIR", str(tmp_path))
    sizes = bench_torch.QUICK
    fasta, bam = bench_torch._dataset(*sizes["main"][:4])
    tree = bench_torch.get_trained_params(sizes, torch.device("cpu"))
    params = params_from_numpy(tree, device="cpu")
    _, forward = make_wire_forward_fn()
    run = bench_torch.timed_runs(
        bam, fasta, PileupConfig(batch_size=2048), CallConfig(show_ref=False),
        params, forward, n_runs=1, chunk_size=sizes["chunk_size"])
    port = bench_torch._vcf_body(bam + ".bench_out.vcf")

    from tests.torch_jax_host import jax_host_body

    want, n = jax_host_body(bam, fasta, str(tmp_path / "jax.vcf"), tree,
                            contigs=["chr1"], chunk_size=sizes["chunk_size"])
    assert run["n_candidates"] == n > 0
    assert port and port == want


def test_weights_cache_keyed_on_recipe(tmp_path, monkeypatch):
    """Cached bench weights are reused only for the recipe that trained
    them: the same sizes load the cache, another epoch count retrains
    into the same file, and nothing is left beside it but its recipe."""
    import bench_torch
    import clair3_rna_torch.cli
    from clair3_rna_torch.models.network import init_params
    from clair3_rna_torch.models.params_io import params_to_numpy, save_params

    calls = []

    def fake_cli(argv):
        calls.append(argv[0])
        if argv[0] == "train":
            out = argv[argv.index("--output_fn") + 1]
            epochs = int(argv[argv.index("--max_epochs") + 1])
            save_params(out, params_to_numpy(init_params(epochs,
                                                         device="cpu")))

    monkeypatch.setattr(clair3_rna_torch.cli, "main", fake_cli)
    monkeypatch.setattr(bench_torch, "DATA_DIR", str(tmp_path))
    cpu = torch.device("cpu")
    train_set = ("ref.fa", "reads.bam", "truth.vcf")
    first = bench_torch.get_trained_params(bench_torch.FULL, cpu, train_set)
    assert calls == ["tensor2bin", "train"]
    assert bench_torch.weights_cached(bench_torch.FULL)
    again = bench_torch.get_trained_params(bench_torch.FULL, cpu, train_set)
    assert calls == ["tensor2bin", "train"]
    assert (again["l4"]["kernel"] == first["l4"]["kernel"]).all()
    other = dict(bench_torch.FULL,
                 train=bench_torch.FULL["train"][:3] + (7,))
    assert not bench_torch.weights_cached(other)
    retrained = bench_torch.get_trained_params(other, cpu, train_set)
    assert calls == ["tensor2bin", "train"] * 2
    assert not (retrained["l4"]["kernel"] == first["l4"]["kernel"]).all()
    assert sorted(os.listdir(tmp_path)) == ["torch_bench_weights.npz",
                                            "torch_bench_weights.recipe.json"]
