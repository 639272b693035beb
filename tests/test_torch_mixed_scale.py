"""tools/torch_mixed_scale_run.py at its smallest size on the CPU, held to
the JAX package: its dataset (two contigs at 14x, three islands a contig
at +246x) is the bytes that tools/mixed_scale_run.py's make_data writes at
the same (cut) sizes; its host, fused and hybrid children write one body,
and that body is the JAX package's host route (run_calling over every
contig) on the same dataset and weights. The tool raises when its own
bodies differ; the test reads them again."""

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


def _quick_data_dir(root):
    import torch_mixed_scale_run as tmx
    q = tmx.QUICK
    return root / f"mixed_2x{q['contig_len']}_14+246x{q['island_len']}_777"


def test_mixed_dataset_matches_mixed_scale_run_py(tmp_path, monkeypatch):
    """torch_mixed_scale_run's quick dataset is what tools/
    mixed_scale_run.py's make_data writes with its sizes cut to the
    same: the islands at each contig's quarters, at 14 + 246x."""
    import mixed_scale_run
    import torch_mixed_scale_run as tmx
    import torch_scale_run as tsr

    q = tmx.QUICK
    n_var = tsr.n_variants_for(q["contig_len"], tmx.N_VARIANTS,
                               tmx.CONTIG_LEN)
    monkeypatch.setattr(mixed_scale_run, "DATA_DIR", str(tmp_path / "jax"))
    monkeypatch.setattr(mixed_scale_run, "CONTIG_LEN", q["contig_len"])
    monkeypatch.setattr(mixed_scale_run, "ISLAND_LEN", q["island_len"])
    monkeypatch.setattr(mixed_scale_run, "N_VARIANTS", n_var)
    for name in ("N_CONTIGS", "DEPTH", "ISLANDS_PER_CONTIG",
                 "ISLAND_EXTRA_DEPTH", "SEED"):
        assert getattr(mixed_scale_run, name) == getattr(tmx, name), name
    for name in ("DEPTH", "ERROR_RATE", "READ_LEN"):
        assert getattr(mixed_scale_run, name) == getattr(tsr, name), name
    mixed_scale_run.make_data()
    port = tmp_path / "port"
    tsr.make_data(str(port), tmx.N_CONTIGS, q["contig_len"], n_var,
                  seed=tmx.SEED, extra=tmx.islands(q["contig_len"],
                                                   q["island_len"]))
    for f in ("ref.fa", "reads.bam", "reads.bam.bai"):
        assert _bytes(port / f) == _bytes(tmp_path / "jax" / f), f


def test_mixed_scale_run_routes_agree(tmp_path, monkeypatch):
    import bench_torch
    import torch_mixed_scale_run as tmx
    import torch_scale_run as tsr
    from clair3_rna_torch.models.params_io import load_params
    from tests.torch_jax_host import jax_host_body

    # the tool points bench_torch.DATA_DIR at tmp_path; restored after
    monkeypatch.setattr(bench_torch, "DATA_DIR", bench_torch.DATA_DIR)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    res = tmx.main(["--quick", "--device", "cpu", "--data-dir",
                    str(tmp_path)])
    data = _quick_data_dir(tmp_path)
    bodies = {n: tsr.body(os.path.join(data, "run", n, "full.vcf"))
              for n in ("host", "fused", "hybrid")}
    assert bodies["host"] and bodies["fused"] == bodies["hybrid"] \
        == bodies["host"]
    assert res["rows_identical"] and res["n_rows"] == len(bodies["host"])
    assert res["dataset"]["island_depth"] == 260
    assert res["hybrid"]["vs_best_pure"] > 0
    assert isinstance(res["routing_mixed"], bool)
    # the islands push coverage past the renormalisation threshold
    assert res["fused"]["fused_counters"]["renorm_candidates"] > 0

    # the JAX package on the same dataset and the weights the children
    # loaded: the same body, the same candidates
    tree = load_params(bench_torch.weights_path(bench_torch.QUICK))
    want, n = jax_host_body(str(data / "reads.bam"), str(data / "ref.fa"),
                            str(tmp_path / "jax.vcf"), tree,
                            chunk_size=tsr.CHUNK_SIZE)
    assert bodies["host"] == want
    assert res["host"]["candidates"] == n
