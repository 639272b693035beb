"""The readers of the program's chunk spans (the joblog's route, epoch and
stage columns) on hand-made joblogs: each formula, and nothing read from a
joblog of the five older columns or, for the fused readers, from
host-route chunks."""

import json
import os

import pytest

from callbench import run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
STAGES = ("extract_s", "stage_s", "h2d_s", "launch_s", "sync_s", "escape_s",
          "decode_s")
NEW = ("pipeline.wait_pct", "pipeline.serial_pct",
       "fused.extract_s_per_gbase", "fused.stage_s_per_gbase",
       "fused.launch_s_per_gbase", "fused.sync_s_per_gbase",
       "fused.decode_s_per_gbase", "fused.rework_pct")


def _row(route, start, done, wait, stages=(0.0,) * 7, retries=0):
    row = {"contig": "c", "start": "0", "end": "100", "candidates": "5",
           "build_seconds": "1.0", "route": route, "worker": "0",
           "starttime": f"{start:.6f}", "donetime": f"{done:.6f}",
           "wait_s": f"{wait:.6f}", "staged_rows": "", "k1_bytes": "",
           "budget": "", "retries": str(retries)}
    row.update({k: f"{v:.6f}" for k, v in zip(STAGES, stages)})
    return row


def _ctx(jobs):
    return {"jobs": jobs, "gbases": sum(j["read_bases"] for j in jobs) / 1e9}


def _job(rows, wall, bases=10**9):
    return {"read_bases": bases, "joblog_rows": [rows],
            "stats": [{"wall_s": wall}]}


@pytest.fixture(scope="module")
def read():
    return {n: run.metric_reader(n) for n in NEW}


def test_new_readers_are_declared():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        per_layer = {m["name"]: m for m in json.load(f)["per_layer"]}
    for name in NEW:
        m = per_layer[name]
        assert (m["source"], m["moves"], m["better"], m["workloads"]) == (
            "program_counter", "mbases_per_s", "lower",
            ["c18_ont.expr_skew.fused"])


def test_formulas_on_a_hand_made_window(read):
    # job 1: wall 10 s, chunks from epoch 100.0 to 108.0; job 2: wall 5 s,
    # chunks from 200.5 to 204.0 -> serial (10 - 8) + (5 - 3.5) = 3.5 s
    s1 = (0.1, 0.2, 0.05, 0.3, 0.4, 0.01, 0.06)
    s2 = (0.2, 0.1, 0.05, 0.2, 0.1, 0.02, 0.04)
    j1 = _job([_row("fused", 100.0, 104.0, 2.0, s1),
               _row("fused", 101.0, 108.0, 3.0, s2, retries=1)], 10.0)
    j2 = _job([_row("fallback", 200.5, 202.0, 1.0, s1),
               _row("host", 201.0, 204.0, 0.5)], 5.0, bases=3 * 10**9)
    ctx = _ctx([j1, j2])  # 4 Gbases
    assert read["pipeline.wait_pct"](ctx) == pytest.approx(100 * 6.5 / 15)
    assert read["pipeline.serial_pct"](ctx) == pytest.approx(100 * 3.5 / 15)
    sums = [a + b + c for a, b, c in zip(s1, s2, s1)]  # the fused-attempted
    want = {"fused.extract_s_per_gbase": sums[0] / 4,
            "fused.stage_s_per_gbase": (sums[1] + sums[2]) / 4,
            "fused.launch_s_per_gbase": sums[3] / 4,
            "fused.sync_s_per_gbase": sums[4] / 4,
            "fused.decode_s_per_gbase": (sums[6] + sums[5]) / 4}
    for name, value in want.items():
        assert read[name](ctx) == pytest.approx(value), name
    # one retry and one fallback over three fused-attempted chunks
    assert read["fused.rework_pct"](ctx) == pytest.approx(100 * 2 / 3)


def test_nothing_read_from_older_joblogs(read):
    old = [{"contig": "c", "start": "0", "end": "100", "candidates": "5",
            "build_seconds": "1.0"}] * 3
    ctx = _ctx([_job(old, 10.0)])
    for name in NEW:
        assert read[name](ctx) is None, name
    assert read["pipeline.wait_pct"](_ctx([_job([], 10.0)])) is None


def test_fused_readers_read_nothing_from_host_chunks(read):
    """Host-route chunks carry zero stage columns: the fused readers read
    nothing there; the pipeline readers, which hold for every route,
    do."""
    ctx = _ctx([_job([_row("host", 10.0, 12.0, 1.0),
                      _row("host", 10.5, 13.0, 0.5)], 4.0)])
    for name in NEW:
        if name.startswith("fused."):
            assert read[name](ctx) is None, name
    assert read["pipeline.wait_pct"](ctx) == pytest.approx(100 * 1.5 / 4)
    assert read["pipeline.serial_pct"](ctx) == pytest.approx(100 * 1.0 / 4)
