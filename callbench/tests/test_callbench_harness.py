"""The harness on the CPU: the contract's names and files, a cell and a
configuration (the phased re-call, 30 channels) added by files alone (each
driven through a whole run), the metric readers, the import guard, the
refusal without a card, and faults planted in the timed path coming out as
not correct."""

import ast
import hashlib
import json
import os
import re
import subprocess
import sys
import types

import pytest

from callbench import harness, run
from callbench.lib.guard import forbidden_modules
from callbench.lib.trace import device_activity
from callbench.tests.small import (CALL, LIMITS, SKEW, add_config,
                                   copy_with_cell)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_names_units_and_files():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"] + [c["name"]])
        assert c["file"] == f"callbench/configs/{c['name']}.json"
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for key in ("name", "config", "traffic"):
            assert NAME.match(w[key]), w[key]
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        for path in (f"traffic/{w['traffic']}.json", f"cells/{w['name']}.json"):
            assert os.path.exists(os.path.join(ROOT, "callbench", path))
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in b["per_layer"]:
        assert os.path.exists(os.path.join(
            ROOT, "callbench", "metrics", m["name"] + ".py"))
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
    assert len(names) == len(set(names))
    assert len(json.dumps(b)) < 64 * 1024


def test_weights_match_their_manifest():
    d = os.path.join(ROOT, "callbench", "configs")
    for name in sorted(n for n in os.listdir(d) if n.endswith(".json")):
        with open(os.path.join(d, name)) as f:
            cfg = json.load(f)
        assert cfg["name"] + ".json" == name
        with open(os.path.join(ROOT, cfg["weights"]), "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        assert digest == cfg["weights_sha256"], name
        with open(os.path.join(ROOT, cfg["weights_recipe"])) as f:
            assert json.load(f)["sha256"] == digest, name


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("bench"))
    copy_with_cell(tmp, ROOT, "c18_ont.small.host", "c18_ont", SKEW, CALL,
                   LIMITS)
    return tmp


def test_new_cell_from_files_alone_runs_correct(small_root):
    before = {p: open(os.path.join(ROOT, p), "rb").read()
              for p in ("BENCHMARK.json",)}
    r = run.measure("c18_ont.small.host", 2**31 + 5, 1.0, False, device="cpu",
                    root=small_root)
    assert r["correct"] and r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {"mbases_per_s", "peak_rss_gb", "setup_s"}
    assert r["metrics"]["mbases_per_s"]["value"] > 0
    assert list(r)[-1] == "checks"
    assert before == {p: open(os.path.join(ROOT, p), "rb").read() for p in before}


def _tree(root):
    """sha256 of BENCHMARK.json and of every file under callbench/."""
    paths = [os.path.join(root, "BENCHMARK.json")]
    for d, dirs, files in os.walk(os.path.join(root, "callbench")):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        paths += [os.path.join(d, f) for f in files]
    return {p: hashlib.sha256(open(p, "rb").read()).hexdigest() for p in paths}


PHASED = {"other_channel_rows": 0, "jobs_without_phased_rows": 0,
          "haplotype_channels_empty": 0}


def _phased_copy(tmp, module):
    """A copy of the benchmark with configuration cX (30 channels, the
    phased re-call of callbench/tests/phased_recall.py when `module`) and
    its cell cX.hp_skew on HP-tagged reads: new files and entries alone."""
    copy_with_cell(tmp, ROOT, "cX.hp_skew", "cX", dict(SKEW, hp_tags=True),
                   CALL, PHASED)
    with open(os.path.join(ROOT, "callbench", "configs", "c18_ont.json")) as f:
        cfg = json.load(f)
    for key in ("weights", "weights_sha256", "weights_recipe",
                "weights_trainer"):
        cfg.pop(key)
    add_config(tmp, "cX", dict(cfg, channels=30, model="phased re-call"),
               os.path.join(ROOT, "callbench", "tests", "phased_recall.py")
               if module else None)


def test_new_configuration_from_files_alone_runs_correct(tmp_path,
                                                          monkeypatch):
    before = _tree(ROOT)
    _phased_copy(str(tmp_path), module=True)
    keys = []
    real = harness.host_rows

    def host_rows(rows):
        out = real(rows)
        keys.append(sorted(out))
        return out
    monkeypatch.setattr(harness, "host_rows", host_rows)
    r = run.measure("cX.hp_skew", 2**31 + 8, 1.0, False, device="cpu",
                    root=str(tmp_path))
    assert r["correct"] and r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["checks"]) == set(PHASED)
    assert all(c["value"] == 0 for c in r["checks"].values()), r["checks"]
    assert keys and all(k == [30] for k in keys), keys
    assert r["metrics"]["mbases_per_s"]["value"] > 0
    assert _tree(ROOT) == before


def test_configuration_without_its_module_fails_at_load(tmp_path):
    _phased_copy(str(tmp_path), module=False)
    path = os.path.join(str(tmp_path), "callbench", "configs", "cX.py")
    with pytest.raises(FileNotFoundError, match=re.escape(path)):
        run.measure("cX.hp_skew", 1, 1.0, False, device="cpu",
                    root=str(tmp_path))


def test_every_configuration_has_load_job_and_check():
    for c in _bench()["configs"]:
        mod = harness.config_module(c["name"])
        for fn in ("load", "job", "check"):
            assert callable(getattr(mod, fn, None)), (c["name"], fn)


def _answer_altered(monkeypatch):
    from clair3_rna_torch.caller import pipeline
    real = pipeline.decode_batch

    def altered(*a, **k):
        rows = real(*a, **k)
        if rows:
            cols = rows[0].split("\t")
            cols[4] += "A"
            rows[0] = "\t".join(cols)
        return rows
    monkeypatch.setattr(pipeline, "decode_batch", altered)


def _half_left_out(monkeypatch):
    from clair3_rna_torch.caller import pipeline
    real = pipeline.build_chunk_tensors

    def half(*a, **k):
        out = real(*a, **k)
        return (out[0][::2],) + tuple(out[1:])
    monkeypatch.setattr(pipeline, "build_chunk_tensors", half)


@pytest.mark.parametrize("fault", [_answer_altered, _half_left_out])
def test_fault_in_timed_path_is_not_correct(small_root, monkeypatch, fault):
    fault(monkeypatch)
    r = run.measure("c18_ont.small.host", 2**31 + 6, 1.0, False, device="cpu",
                    root=small_root)
    assert not r["correct"], r["checks"]


def _job(build, decode, bases, log=(), rows=1000):
    return {"read_bases": bases, "joblog_rows": [list(log)],
            "network_rows": {18: rows},
            "stats": [{"build_s": build, "decode_s": decode}]}


def test_metric_readers_on_canned_runs():
    names = [n[:-3] for n in os.listdir(os.path.join(ROOT, "callbench", "metrics"))
             if n.endswith(".py")]
    read = {n: run.metric_reader(n) for n in names}
    assert {m["name"] for m in _bench()["per_layer"]} <= set(read)
    log = [{"build_seconds": str(0.01 * i)} for i in range(1, 101)]
    jobs = [_job(2.0, 0.5, 10**9, log), _job(1.0, 0.25, 10**9, ())]
    ctx = {"jobs": jobs, "window_s": 10.0, "gbases": 2.0, "activity": None,
           "cfg": json.load(open(os.path.join(ROOT, "callbench/configs/c18_ont.json"))),
           "traffic": SKEW}
    assert read["pileup.build_cpu_s_per_gbase"](ctx) == pytest.approx(1.5)
    assert read["decode.cpu_s_per_gbase"](ctx) == pytest.approx(0.375)
    assert read["pipeline.chunk_build_p95_ms"](ctx) == pytest.approx(950.0, rel=0.01)
    # 2,000 rows x 47,785,984 FLOP over 10 s at 67 TFLOP/s
    assert read["step.mfu_pct"](ctx) == pytest.approx(
        100 * 2000 * 47785984 / (10 * 67e12))
    assert read["device.idle_pct"](ctx) is None
    ctx["jobs"] = [_job(0.0, 0.0, 10**9)]
    assert read["decode.cpu_s_per_gbase"](ctx) is None
    assert read["pipeline.chunk_build_p95_ms"](ctx) is None


def test_device_idle_against_a_hand_worked_trace(tmp_path):
    # host 0-100 us; kernel 10-30, copy 25-40, kernel 60-70: busy 30 + 10
    ev = [{"ph": "X", "cat": "user_annotation", "name": "PyTorch Profiler (0)",
           "ts": 0, "dur": 100},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 100},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10, "dur": 20},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 25, "dur": 15},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 60, "dur": 10}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    act = device_activity(str(path))
    assert act["busy_s"] == pytest.approx(40e-6)
    assert act["window_s"] == pytest.approx(100e-6)
    assert act["device_ops"][0] == ["k1", pytest.approx(30e-6)]
    assert act["idle_gaps"][0] == ["aten::mm", pytest.approx(30e-6)]
    idle = run.metric_reader("device.idle_pct")({"activity": act})
    assert idle == pytest.approx(60.0)


def test_import_guard_compares_whole_top_level_names():
    assert forbidden_modules(["jax.numpy", "jaxtyping", "clair3_rna_torch.cli",
                              "clair3_rna_tpu.ops", "flax", "numpy"]) \
        == ["clair3_rna_tpu", "flax", "jax"]
    assert forbidden_modules(["clair3_rna_torch", "optaxx"]) == []


def _imports_in(nodes):
    for top in nodes:
        for node in ast.walk(top):
            if isinstance(node, ast.Import):
                yield from (a.name for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.module:
                yield node.module


def _imports_of(path):
    return _imports_in([ast.parse(open(path).read())])


def _check_imports(path):
    """The imports a configuration module's check can see: the module's own
    (outside any function) and those inside check."""
    body = ast.parse(open(path).read()).body
    return _imports_in(
        n for n in body if not isinstance(n, (ast.FunctionDef, ast.ClassDef))
        or (isinstance(n, ast.FunctionDef) and n.name == "check"))


def test_reference_and_generator_import_nothing_of_the_program():
    program = {"clair3_rna_torch", "clair3_rna_tpu", "jax", "flax", "optax"}
    for sub in ("reference", "gen"):
        d = os.path.join(ROOT, "callbench", sub)
        for name in os.listdir(d):
            if name.endswith(".py"):
                tops = {m.split(".")[0] for m in _imports_of(os.path.join(d, name))}
                assert not tops & program, (name, tops)
    d = os.path.join(ROOT, "callbench", "configs")
    configs = sorted(n[:-3] for n in os.listdir(d) if n.endswith(".py"))
    assert configs
    for name in configs:
        tops = {m.split(".")[0]
                for m in _check_imports(os.path.join(d, name + ".py"))}
        assert not tops & program, (name, tops)
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import callbench.gen, callbench.gen.bam, callbench.reference.judge, "
            "callbench.reference.network, callbench.reference.pileup\n"
            "from callbench.harness import config_module\n"
            "for name in %r: config_module(name)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % (ROOT, configs))
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True).stdout
    assert "clair3_rna_torch" not in out and "'jax'" not in out


def test_run_loads_no_jax_at_any_depth():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import callbench.run, callbench.harness, callbench.control\n"
            "import clair3_rna_torch.caller.pipeline, clair3_rna_torch.ops.fused_pileup\n"
            "import clair3_rna_torch.csrc, clair3_rna_torch.native\n"
            "import torch.profiler\n"
            "from callbench.lib.guard import forbidden_modules\n"
            "print(forbidden_modules())" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         env=dict(os.environ, USE_FLAX="0")).stdout
    assert out.strip() == "[]"


def test_no_card_no_result(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(run, "measure", lambda *a, **k: pytest.fail("measured"))
    assert run.main(["--workload", _bench()["workloads"][0]["name"],
                     "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_forbidden_module_means_no_result(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "measure", lambda *a, **k: {"checks": {}})
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run.main(["--workload", _bench()["workloads"][0]["name"],
                     "--seed", "1", "--seconds", "1"]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "jax" in out.err


@pytest.mark.cuda
def test_control_reads_over_the_limit_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("the control runs in TF32, which needs a CUDA card")
    from callbench.control import control_numbers
    from callbench.harness import load_cell
    _, cfg, _, _ = load_cell(_bench()["workloads"][0]["name"])
    fp32 = control_numbers(cfg, SKEW, 2**31 + 7, "cuda", tf32=False)
    tf32 = control_numbers(cfg, SKEW, 2**31 + 7, "cuda", tf32=True)
    limit = run.limits_for(_bench()["workloads"][0]["name"])["prob_gap"]
    assert fp32["prob_gap"] == 0.0
    assert tf32["prob_gap"] > limit
