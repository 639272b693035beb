"""Configuration c30_ont_phased on the CPU: the two-pass reference (phaser,
30-channel pileup, the phasing model) against the program's
`call --enable_phasing_model` second pass on a small generated contig, the
new cell driven through a whole run on a copy of the benchmark, and faults
planted in the timed path (a read's HP flipped, a record dropped, a
30-channel count altered) coming out as not correct."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from callbench import run
from callbench.gen.bam import write_sample
from callbench.reference import network
from callbench.reference.bam import read_hp
from callbench.reference.judge import expected_rows, match, vcf_body
from callbench.reference.twopass import two_pass
from callbench.tests.small import SKEW

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
WORKLOAD = "c30_ont_phased.expr_skew.fused"
SEED = 2**31 + 123
with open(os.path.join(ROOT, "callbench", "configs", "c30_ont_phased.json")) as _f:
    CFG = json.load(_f)
C18 = os.path.join(ROOT, CFG["first_pass_weights"])
C30 = os.path.join(ROOT, CFG["weights"])


def _config_module():
    from callbench.harness import config_module
    return config_module("c30_ont_phased")


def _random_weights(path):
    from callbench.reference.train import keras_layout, make_net
    torch.manual_seed(11)
    out = str(path / "random30.npz")
    np.savez(out, **keras_layout(make_net(30)))
    return out


@pytest.fixture(scope="module")
def program(tmp_path_factory):
    """The program's two passes of contig 0 on the CPU, fused route, first
    pass on c18_ont.npz; the second pass twice, on seeded random
    30-channel weights and on the committed ones -> the rows each network
    took and gave, the VCF bodies and the tagged BAM's records."""
    from clair3_rna_torch.caller.decode import CallConfig
    from clair3_rna_torch.caller.driver import run_second_pass
    from clair3_rna_torch.caller.pipeline import run_calling
    from clair3_rna_torch.config import PileupConfig
    from clair3_rna_torch.models.network import make_wire_forward_fn
    from clair3_rna_torch.models.params_io import load_params, params_from_numpy

    tmp = tmp_path_factory.mktemp("phased")
    info = write_sample(SKEW, SEED, 0, str(tmp))
    cfg = PileupConfig.for_platform(
        CFG["preset"], min_mq=CFG["min_mq"], min_bq=CFG["min_bq"],
        min_coverage=CFG["min_coverage"], snp_min_af=CFG["snp_min_af"],
        indel_min_af=CFG["indel_min_af"], batch_size=CFG["batch_size"])
    _, fwd = make_wire_forward_fn()
    rows = []
    hook = torch.nn.modules.module.register_module_forward_hook(
        lambda m, i, o: rows.append((i[0].clone(), o.clone()))
        if type(m).__name__ == "PileupNet" else None)
    common = dict(call_cfg=CallConfig(), forward=fwd, contigs=[info["name"]],
                  chunk_size=20000, progress=False, pileup_backend="fused",
                  device="cpu")

    def taken():
        x = torch.cat([a for a, _ in rows]).numpy().astype(np.int32)
        p = torch.cat([b for _, b in rows]).numpy()
        rows.clear()
        return x, p

    out = {"info": info}
    try:
        first, _ = run_calling(
            info["bam"], info["fasta"], str(tmp / "output.vcf"), cfg=cfg,
            params=params_from_numpy(load_params(C18), device="cpu"),
            manifest_dir=str(tmp / "tmp"), **common)
        out["first"] = taken() + (vcf_body(first[0]),)
        for name, path in (("random", _random_weights(tmp)), ("committed", C30)):
            d = tmp / name
            second, stats = run_second_pass(
                info["bam"], info["fasta"], first[0], str(d), cfg=cfg,
                params=params_from_numpy(load_params(path), device="cpu"),
                **common)
            out[name] = taken() + (vcf_body(second[0]), path)
            out[name + "_records"] = read_hp(str(d / "phased_tagged.bam"))
            out[name + "_phase"] = stats.phase
    finally:
        hook.remove()
    return out


@pytest.fixture(scope="module")
def reference():
    return two_pass(SKEW, SEED, CFG, [0], "cpu", ROOT)


def test_reference_phaser_equals_program(program, reference):
    name = program["info"]["name"]
    hp = reference.hp[name]
    records = program["random_records"]
    assert _config_module().hp_mismatch(hp, records) == 0
    assert (hp == 1).sum() > 100 and (hp == 2).sum() > 100
    ph = program["random_phase"]
    assert (ph["tagged_hp1"], ph["tagged_hp2"]) == (int((hp == 1).sum()),
                                                    int((hp == 2).sum()))
    assert ph["records_written"] == len(hp) == len(records)
    assert program["committed_records"] == records


@pytest.mark.parametrize("weights", ["random", "committed"])
def test_phased_reference_equals_program(program, reference, weights):
    name = program["info"]["name"]
    x, p, body, path = program[weights]
    assert x.shape[-1] == 30
    cands = reference.phased[name]
    assert len(cands.pos) > 200
    assert (np.abs(cands.tensors[:, :, 18:]).sum(axis=(1, 2)) > 0).mean() > 0.5
    assert np.array_equal(cands.tensors[:, :, :18], reference.first[name].tensors)
    probs, missing = match(cands, x, p)
    assert missing == 0
    ref = network.probabilities(network.load_weights(path), cands.tensors, "cpu")
    assert np.abs(probs - ref).max() < 1e-5
    assert expected_rows(cands, probs, CFG["qual_cutoff"]) == body
    assert expected_rows(cands, ref, CFG["qual_cutoff"]) == body
    # the first pass: its candidates, probabilities and rows, as c18_ont's
    x1, p1, body1 = program["first"]
    probs1, missing1 = match(reference.first[name], x1, p1)
    assert missing1 == 0
    assert np.abs(probs1 - reference.first_probs[name]).max() < 1e-5
    assert reference.first_rows[name] == body1


def _bench_copy(tmp):
    """The benchmark's files in tmp, the cells' traffic at the small SKEW
    shape: nothing of the repository is edited."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp)
    shutil.copytree(os.path.join(ROOT, "callbench"), os.path.join(tmp, "callbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(tmp, "callbench", "traffic", "expr_skew.json"), "w") as f:
        json.dump(SKEW, f)
    path = os.path.join(tmp, "callbench", "cells", WORKLOAD + ".json")
    with open(path) as f:
        cell = json.load(f)
    cell["call"]["chunk_size"] = 20000
    with open(path, "w") as f:
        json.dump(cell, f)
    return tmp


@pytest.fixture(scope="module")
def bench_copy(tmp_path_factory):
    return _bench_copy(str(tmp_path_factory.mktemp("bench30")))


def test_new_cell_runs_correct(bench_copy):
    r = run.measure(WORKLOAD, 2**31 + 31, 1.0, True, device="cpu",
                    root=bench_copy)
    assert r["correct"] and r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["checks"]) == {
        "missing_candidates", "prob_gap", "row_mismatch", "ref_row_mismatch",
        "phased_missing_candidates", "phased_prob_gap", "phased_row_mismatch",
        "phased_ref_row_mismatch", "hp_mismatch"}
    # no CUDA graph and no device activity on the CPU: the graph share
    # reads 0 and the idle share has no trace to read
    assert set(r["metrics"]) == {
        "phase.share_pct", "phase.scan_s_per_gbase", "phase.link_s_per_gbase",
        "phase.rewrite_s_per_gbase", "twopass.mfu_pct",
        "twopass.graph_slab_pct"}
    assert 0 < r["metrics"]["phase.share_pct"]["value"] < 100
    metrics = dict(r["metrics"])
    assert metrics.pop("twopass.graph_slab_pct")["value"] == 0.0
    assert all(m["value"] > 0 for m in metrics.values())


def _hp_flipped(monkeypatch):
    from clair3_rna_torch.phasing import pipeline

    class Writer(pipeline.BamWriter):
        flipped = False

        def write(self, rec):
            if not self.flipped and rec.tags.get("HP") in (1, 2):
                rec.tags["HP"] = 3 - rec.tags["HP"]
                self.flipped = True
            super().write(rec)
    monkeypatch.setattr(pipeline, "BamWriter", Writer)


def _record_dropped(monkeypatch):
    from clair3_rna_torch.phasing import pipeline

    class Writer(pipeline.BamWriter):
        dropped = False

        def write(self, rec):
            if not self.dropped:
                self.dropped = True
                return
            super().write(rec)
    monkeypatch.setattr(pipeline, "BamWriter", Writer)


def _count_altered(monkeypatch):
    """One count of a haplotype channel of one row, in every 30-channel
    network call."""
    def alter(module, inputs):
        x = inputs[0]
        if type(module).__name__ != "PileupNet" or x.shape[-1] != 30:
            return None
        rows = torch.nonzero(x[:, :, 18:].abs().sum(dim=(1, 2)))
        if not len(rows):
            return None
        x = x.clone()
        x[int(rows[0]), 16, 18] += 1
        return (x,) + tuple(inputs[1:])
    return torch.nn.modules.module.register_module_forward_pre_hook(alter)


@pytest.mark.parametrize("fault", [_hp_flipped, _record_dropped,
                                   _count_altered])
def test_fault_in_timed_path_is_not_correct(bench_copy, monkeypatch, fault):
    handle = fault(monkeypatch)
    try:
        r = run.measure(WORKLOAD, 2**31 + 32, 1.0, False, device="cpu",
                        root=bench_copy)
    finally:
        if handle is not None:
            handle.remove()
    assert not r["correct"], r["checks"]


def test_first_pass_weights_are_c18_onts():
    with open(C18, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == \
            CFG["first_pass_weights_sha256"]
    with open(os.path.join(ROOT, "callbench", "configs", "c18_ont.json")) as f:
        c18 = json.load(f)
    assert (CFG["first_pass_weights"], CFG["first_pass_weights_sha256"]) == \
        (c18["weights"], c18["weights_sha256"])
    for key in ("positions", "lstm1_units", "lstm2_units", "dense_units",
                "head_units", "outputs", "preset", "min_mq", "min_bq",
                "min_coverage", "snp_min_af", "indel_min_af", "max_depth",
                "qual_cutoff", "batch_size"):
        assert CFG[key] == c18[key], key
    assert (CFG["channels"], CFG["first_pass_channels"]) == (30, 18)
    w = network.load_weights(C30)
    assert w["lstm1/forward/kernel"].shape == (30, 4 * 128)


def _job(phase_s, wall_s, bases, scan=1.0, link=0.5, rewrite=2.0):
    return {"read_bases": bases, "wall_s": wall_s,
            "network_rows": {18: 1000, 30: 500},
            "phase": {"phase_s": phase_s, "scan_s": scan, "link_s": link,
                      "rewrite_s": rewrite}}


def test_metric_readers_on_canned_jobs():
    read = {n: run.metric_reader(n) for n in (
        "phase.share_pct", "phase.scan_s_per_gbase", "phase.link_s_per_gbase",
        "phase.rewrite_s_per_gbase", "twopass.mfu_pct", "step.mfu_pct")}
    ctx = {"jobs": [_job(8.0, 10.0, 10**9), _job(4.0, 10.0, 10**9)],
           "window_s": 20.0, "gbases": 2.0, "activity": None, "cfg": CFG}
    assert read["phase.share_pct"](ctx) == pytest.approx(60.0)
    assert read["phase.scan_s_per_gbase"](ctx) == pytest.approx(1.0)
    assert read["phase.link_s_per_gbase"](ctx) == pytest.approx(0.5)
    assert read["phase.rewrite_s_per_gbase"](ctx) == pytest.approx(2.0)
    # 2,000 rows at 18 channels (47,785,984 FLOP) and 1,000 at 30
    # (48,596,992: the first LSTM's input matmul, 33 x 2 x 4 x 128 x 12
    # more multiply-adds) over 20 s at 67 TFLOP/s
    want = 100 * (2000 * 47785984 + 1000 * 48596992) / (20 * 67e12)
    assert read["twopass.mfu_pct"](ctx) == pytest.approx(want)
    assert read["step.mfu_pct"](ctx) == pytest.approx(want)
    ctx["jobs"] = [dict(j, phase=None) for j in ctx["jobs"]]
    for name in ("phase.share_pct", "phase.scan_s_per_gbase",
                 "phase.link_s_per_gbase", "phase.rewrite_s_per_gbase"):
        assert read[name](ctx) is None


def _slab_rows(graph):
    return [{"route": "fused", "net_slabs": "4", "net_graph_slabs": str(graph)}]


def test_twopass_readers_are_the_accepted_ones():
    """twopass.graph_slab_pct reads both passes' joblogs of a job as
    net.graph_slab_pct does; twopass.idle_pct reads the profiled job's
    trace as device.idle_pct does."""
    read = {n: run.metric_reader(n) for n in (
        "twopass.graph_slab_pct", "net.graph_slab_pct", "twopass.idle_pct",
        "device.idle_pct")}
    ctx = {"jobs": [{"joblog_rows": [_slab_rows(4), _slab_rows(2)]}],
           "activity": {"busy_s": 0.5, "window_s": 20.0}}
    assert read["twopass.graph_slab_pct"](ctx) == pytest.approx(75.0)
    assert read["net.graph_slab_pct"](ctx) == pytest.approx(75.0)
    assert read["twopass.idle_pct"](ctx) == pytest.approx(97.5)
    assert read["device.idle_pct"](ctx) == pytest.approx(97.5)
    assert read["twopass.idle_pct"]({"activity": None}) is None
    assert read["twopass.graph_slab_pct"]({"jobs": []}) is None


def test_new_reference_and_check_import_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import callbench.reference.phase, callbench.reference.bam, "
            "callbench.reference.pileup_phased, callbench.reference.twopass, "
            "callbench.reference.train_phased\n"
            "from callbench.harness import config_module\n"
            "config_module('c30_ont_phased'); config_module('c30_ont_phased_control')\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True).stdout
    assert "clair3_rna_torch" not in out and "'jax'" not in out


@pytest.mark.cuda
def test_control_reads_over_the_limit_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("the control runs in TF32, which needs a CUDA card")
    from callbench.harness import config_module
    control = config_module("c30_ont_phased_control")
    fp32 = control.control_numbers(CFG, SKEW, 2**31 + 7, "cuda", tf32=False)
    tf32 = control.control_numbers(CFG, SKEW, 2**31 + 7, "cuda", tf32=True)
    limit = run.limits_for(WORKLOAD)["phased_prob_gap"]
    assert fp32["phased_prob_gap"] == 0.0
    assert tf32["phased_prob_gap"] > limit
