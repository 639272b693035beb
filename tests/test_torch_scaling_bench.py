"""tools/torch_scaling_bench.py at its quick size on the CPU, held to the
JAX package and to tools/scaling_bench.py: its dataset is the bytes of
tools/scaling_bench.py's _make_data at the same sizes; the dp mesh over
repeated CPU slots at dp 1/2/4 writes one body (the tool raises
otherwise), and that body is the JAX package's host route on the same
dataset and weights; its measured shard balance and GRCh38 projection
are what tools/scaling_bench.py's own functions compute."""

import os
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


def test_scaling_bench_rows_identical_across_dp(tmp_path, monkeypatch):
    import scaling_bench
    import torch_scaling_bench as tsb
    from clair3_rna_torch.models.network import init_params
    from clair3_rna_torch.models.params_io import params_to_numpy
    from tests.torch_jax_host import jax_host_body

    q = tsb.QUICK
    res = tsb.main(["--quick", "--device", "cpu", "--data-dir",
                    str(tmp_path)])
    rows = {r["rows"] for r in res["dp_mesh"].values()}
    assert len(res["dp_mesh"]) == 3 and len(rows) == 1 and rows.pop() > 0
    for eff in (list(res["balance"]["efficiency_by_shards"].values())
                + list(res["projection"]["efficiency_by_shards"].values())):
        assert 0 < eff <= 1
    assert res["projection"]["n_chunks"] == 631

    # the dataset: tools/scaling_bench.py's at the quick sizes
    data = tmp_path / f"scaling_{q['contig_len']}_35_{q['n_variants']}"
    (tmp_path / "jax").mkdir()
    scaling_bench._make_data(str(tmp_path / "jax"),
                             contig_len=q["contig_len"], depth=35,
                             n_variants=q["n_variants"])
    for f in ("ref.fa", "reads.bam"):
        assert _bytes(data / f) == _bytes(tmp_path / "jax" / f), f

    # the body every dp wrote: the JAX host route with the mesh's weights
    # (the port's init_params(0)), batch 512, the same chunks
    tree = params_to_numpy(init_params(0, device="cpu"))
    want, n = jax_host_body(str(data / "reads.bam"), str(data / "ref.fa"),
                            str(tmp_path / "jax.vcf"), tree,
                            contigs=["chr1"], chunk_size=q["chunk"],
                            batch_size=512)
    port = [ln for ln in open(data / "reads.bam.dp.vcf")
            if not ln.startswith("#")]
    assert port == want
    assert {r["candidates"] for r in res["dp_mesh"].values()} == {n}

    # balance and projection: tools/scaling_bench.py's functions, its
    # dataset cut to the quick sizes
    real = scaling_bench._make_data
    monkeypatch.setattr(
        scaling_bench, "_make_data",
        lambda tmpdir: real(tmpdir, contig_len=q["contig_len"],
                            n_variants=q["n_variants"]))
    assert res["balance"] == scaling_bench.measured_shard_balance()
    assert res["projection"] == scaling_bench.genome_projection()
