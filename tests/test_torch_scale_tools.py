"""tools/torch_scale_run.py at its smallest size on the CPU, held to the
JAX package: its dataset is the bytes that tools/scale_run.py's make_data
writes at the same (cut) sizes; its full streaming run, its 8-shard run
merged, the fused route and the hybrid router (each in a clean child
process) write one body, and that body is the JAX package's host route
(run_calling over every contig, as tools/scale_run.py's child calls it)
on the same dataset and weights. The tool raises when its own bodies
differ; the test reads them again."""

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

# what tools/scale_run.py's make_data writes
DATA_FILES = ("ref.fa", "truth_counts.json", "reads.bam", "reads.bam.bai")


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_scale_dataset_matches_scale_run_py(tmp_path, monkeypatch):
    """torch_scale_run.make_data at the quick sizes writes the files of
    tools/scale_run.py's make_data with its sizes cut to the same."""
    import scale_run
    import torch_scale_run as tsr

    q = tsr.QUICK
    monkeypatch.setattr(scale_run, "DATA_DIR", str(tmp_path / "jax"))
    monkeypatch.setattr(scale_run, "N_CONTIGS", q["n_contigs"])
    monkeypatch.setattr(scale_run, "CONTIG_LEN", q["contig_len"])
    monkeypatch.setattr(scale_run, "N_VARIANTS",
                        tsr.n_variants_for(q["contig_len"]))
    for name in ("DEPTH", "ERROR_RATE", "READ_LEN", "SEED", "CHUNK_SIZE"):
        assert getattr(scale_run, name) == getattr(tsr, name), name
    scale_run.make_data()
    tsr.make_data(str(tmp_path / "port"), q["n_contigs"], q["contig_len"],
                  tsr.n_variants_for(q["contig_len"]))
    for f in DATA_FILES:
        assert _bytes(tmp_path / "port" / f) == _bytes(tmp_path / "jax" / f), f


def test_scale_run_shards_and_routes_agree(tmp_path, monkeypatch):
    import bench_torch
    import torch_scale_run as tsr
    from clair3_rna_torch.models.params_io import load_params
    from tests.torch_jax_host import jax_host_body

    # the tool points bench_torch.DATA_DIR at tmp_path; restored after
    monkeypatch.setattr(bench_torch, "DATA_DIR", bench_torch.DATA_DIR)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    res = tsr.main(["--quick", "--device", "cpu", "--data-dir",
                    str(tmp_path)])
    q = tsr.QUICK
    data = tmp_path / f"scale_{q['n_contigs']}x{q['contig_len']}_14_4242"
    run = data / "run"
    bodies = {n: tsr.body(os.path.join(run, n, "full.vcf"))
              for n in ("full", "fused", "hybrid")}
    merged = tsr.body(os.path.join(run, "sharded", "merged.vcf"))
    assert bodies["full"] and merged == bodies["full"]
    assert bodies["fused"] == bodies["hybrid"] == bodies["full"]
    assert res["sharded_8"]["n_rows"] == len(merged)
    assert len(res["sharded_8"]["shard_walls"]) == 8
    assert res["cut"]["run_total_mb"] < res["cut"]["of_total_mb"]
    assert set(res["measured_shard_balance"]) == {8, 16, 32}
    for r in (res["full_run"], res["fused"], res["hybrid"]):
        assert r["child_wall_s"] >= r["wall_s"] + r["ready_s"] - 0.5
        assert r["candidates"] == res["full_run"]["candidates"] > 0
    assert res["fused"]["fused_counters"]["fallback_chunks"] == 0

    # the JAX package on the same dataset and the weights the children
    # loaded: the same body, the same candidates
    tree = load_params(bench_torch.weights_path(bench_torch.QUICK))
    want, n = jax_host_body(str(data / "reads.bam"), str(data / "ref.fa"),
                            str(tmp_path / "jax.vcf"), tree,
                            chunk_size=tsr.CHUNK_SIZE)
    assert bodies["full"] == want
    assert res["full_run"]["candidates"] == n
