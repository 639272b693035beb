"""The port's instruments at their quick size on the CPU: the roofline
(tools/torch_roofline.py) and the wire ablation
(tools/torch_wire_ablation.py) run to their artifacts on bench_torch.py's
quick main dataset, and what they count and write is the JAX package's
host route (run_calling) on the same dataset and weights; the trace
reader of bench_torch.py; every instrument raises without a card unless it
is given --device cpu; the port's demo data equals the JAX demo's.

The instruments import nothing of JAX (tests/test_torch_no_jax.py scans
them); the quick datasets and weights live in a temporary directory."""

import importlib
import json
import os
import sys

import pytest
import torch

# one intra-op thread: the suite runs six worker processes on a
# shared host, where PyTorch's spinning thread pools oversubscribe it
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
for _p in (REPO, TOOLS):
    if _p not in sys.path:
        sys.path.insert(0, _p)

INSTRUMENTS = ["bench_torch", "torch_roofline", "torch_wire_ablation",
               "torch_scale_run", "torch_mixed_scale_run",
               "torch_scaling_bench", "torch_phased_delta"]


@pytest.fixture(scope="module")
def quick(tmp_path_factory):
    """The quick main dataset and weights, made once (bench_torch's
    cache), with bench_torch.DATA_DIR restored afterwards."""
    import bench_torch
    d = str(tmp_path_factory.mktemp("instruments"))
    saved = bench_torch.DATA_DIR
    bench_torch.DATA_DIR = d
    try:
        fasta, bam = bench_torch._dataset(*bench_torch.QUICK["main"][:4])
        tree = bench_torch.get_trained_params(bench_torch.QUICK,
                                              torch.device("cpu"))
        yield {"dir": d, "fasta": fasta, "bam": bam, "tree": tree}
    finally:
        bench_torch.DATA_DIR = saved


@pytest.fixture(scope="module")
def jax_main(quick):
    """The JAX package's host route on the quick main dataset and weights:
    (VCF body, candidates)."""
    import bench_torch
    from tests.torch_jax_host import jax_host_body

    body, n = jax_host_body(quick["bam"], quick["fasta"],
                            os.path.join(quick["dir"], "jax_main.vcf"),
                            quick["tree"], contigs=["chr1"],
                            chunk_size=bench_torch.QUICK["chunk_size"])
    assert body and n > 0
    return body, n


def _fused_run(quick, backend):
    import bench_torch
    from clair3_rna_torch.caller.decode import CallConfig
    from clair3_rna_torch.config import PileupConfig
    from clair3_rna_torch.models.network import make_wire_forward_fn
    from clair3_rna_torch.models.params_io import params_from_numpy

    params = params_from_numpy(quick["tree"], device="cpu")
    _, forward = make_wire_forward_fn()
    run = bench_torch.timed_runs(
        quick["bam"], quick["fasta"], PileupConfig(batch_size=2048),
        CallConfig(show_ref=False), params, forward, n_runs=1,
        chunk_size=bench_torch.QUICK["chunk_size"], backend=backend)
    return run, bench_torch._vcf_body(quick["bam"] + ".bench_out.vcf")


def test_roofline_slices_agree_with_fused_route(quick, jax_main):
    """The roofline's three slices run over the staged chunks; its full
    graph finds the fused route's candidates, which are the JAX package's
    host route's, and the fused route writes the JAX body; a CPU run
    states no share of the card's bound."""
    import torch_roofline
    res = torch_roofline.main(["--quick", "--device", "cpu", "--data-dir",
                               quick["dir"]])
    fused, body = _fused_run(quick, "fused")
    assert body == jax_main[0]
    assert res["n_candidates"] == fused["n_candidates"] == jax_main[1]
    for key in ("kernel_only_s", "front_end_s", "full_graph_s"):
        assert res[key] > 0
    assert res["device"]["type"] == "cpu"
    assert res["kernel_pct_of_roofline"] is None
    assert res["n_events"] > 0 and res["kernel_bytes"] > 0
    assert abs(res["hbm_bytes_per_event"] * res["n_events"]
               - res["kernel_bytes"]) < 1e-3 * res["kernel_bytes"]
    with open(os.path.join(quick["dir"], "torch_roofline_quick.json")) as f:
        assert json.load(f)["n_candidates"] == res["n_candidates"]


def test_wire_ablation_bodies_equal_host_route(quick, jax_main):
    """Both tilelet wires: the fused route's body equals the host route's
    (the tool raises otherwise), and the last one it wrote (the v2 wire's)
    is the JAX package's host body; the nibble wire ships more bytes, and
    the staged fused pass finds the JAX candidates on both wires."""
    import bench_torch
    import torch_wire_ablation
    res = torch_wire_ablation.main(["--quick", "--device", "cpu",
                                    "--data-dir", quick["dir"]])
    v2_body = bench_torch._vcf_body(quick["bam"] + ".bench_out.vcf")
    assert res["vcf_identical"] and v2_body == jax_main[0]
    assert res["n_rows"] == len(jax_main[0])
    assert res["shrink"] > 1.0
    assert (res["nibble"]["device"]["n_candidates"]
            == res["v2"]["device"]["n_candidates"]
            == res["host"]["n_candidates"] == jax_main[1])
    assert res["nibble"]["device"]["wire"] == "nibble"
    assert res["v2"]["device"]["wire"] == "v2"


def test_device_activity_reads_device_rows(tmp_path):
    """bench_torch.device_activity: the union of the device rows (kernels,
    copies, memsets) over the window of every complete event, the kernels
    by device time, the longest gaps; host rows never count as busy."""
    import bench_torch
    ev = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 10, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "k_b", "ts": 20, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 60,
         "dur": 5},
        {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 80, "dur": 10},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 95},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    act = bench_torch.device_activity(str(path), n_gaps=2)
    assert act["window_ms"] == pytest.approx(0.1)
    assert act["busy_ms"] == pytest.approx((30 + 5 + 10) / 1e3)
    assert act["busy_share"] == pytest.approx(0.45)
    assert act["kernel_launches"] == 3
    assert [(k["name"], k["launches"]) for k in act["top_kernels"]] == \
        [("k_a", 2), ("k_b", 1)]
    assert [g["ms"] for g in act["longest_idle_gaps"]] == \
        pytest.approx([0.02, 0.015])
    empty = tmp_path / "cpu.json"
    empty.write_text(json.dumps({"traceEvents": ev[:1]}))
    assert bench_torch.device_activity(str(empty))["busy_share"] is None


@pytest.mark.parametrize("name", INSTRUMENTS)
def test_instrument_refuses_cuda_without_a_card(tmp_path, name):
    """Run as its user would (the card by default), each instrument raises
    on a machine without CUDA, before it simulates or writes anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    mod = importlib.import_module(name)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(["--quick", "--data-dir", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_demo_data_matches_jax_demo(tmp_path):
    """demo/torch_make_demo_data.py writes demo/make_demo_data.py's files
    byte for byte (FASTA, BAM, truth VCF, BED) for the same arguments."""
    import subprocess
    args = ["--contig_len", "6000", "--n_variants", "12", "--seed", "5"]
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    for name, script in (("port", "torch_make_demo_data.py"),
                         ("jax", "make_demo_data.py")):
        subprocess.run([sys.executable, os.path.join(REPO, "demo", script),
                        "--output_dir", str(tmp_path / name), *args],
                       env=env, check=True, capture_output=True, timeout=300)
    for f in ("ref.fa", "reads.bam", "truth.vcf", "high_conf.bed"):
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes(), f
