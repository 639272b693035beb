"""The reader of the network's graph-replayed share
(callbench/metrics/net.graph_slab_pct.py) on hand-made joblogs: its
declaration, its formula over fused-attempted chunks, and nothing read
without fused chunks, without the two columns or without a slab."""

import json
import os

import pytest

from callbench import run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = "net.graph_slab_pct"


def _row(route, slabs=None, graph=None):
    row = {"contig": "c", "start": "0", "end": "100", "candidates": "5",
           "build_seconds": "1.0", "route": route, "retries": "0"}
    if slabs is not None:
        row.update(net_slabs=str(slabs), net_graph_slabs=str(graph))
    return row


def _ctx(*jobs):
    return {"jobs": [{"read_bases": 10**9, "joblog_rows": [list(rows)]}
                     for rows in jobs], "gbases": len(jobs)}


@pytest.fixture(scope="module")
def read():
    return run.metric_reader(NAME)


def test_declared():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        m = {m["name"]: m for m in json.load(f)["per_layer"]}[NAME]
    assert m == {"name": NAME, "unit": "%", "better": "higher",
                 "source": "program_counter",
                 "layer": "model step (models/network.py)",
                 "moves": "mbases_per_s",
                 "workloads": ["c18_ont.expr_skew.fused"]}


def test_share_over_fused_attempted_chunks(read):
    # fused 3 slabs / 2 replayed, a rerun's 2 / 2, a fallback 1 / 0; the
    # host chunk's counts (main-thread batches: 0 / 0) are not read
    ctx = _ctx([_row("fused", 3, 2), _row("fused", 2, 2)],
               [_row("fallback", 1, 0), _row("host", 0, 0)])
    assert read(ctx) == pytest.approx(100 * 4 / 6)
    assert read(_ctx([_row("fused", 4, 4)])) == pytest.approx(100.0)


@pytest.mark.parametrize("jobs", [
    [[_row("host", 0, 0)]],                      # no fused chunk
    [[_row("fused"), _row("fused")]],            # a parent's joblog
    [[_row("fused", 2, 2), _row("fallback")]],   # one row without them
    [[_row("fused", 0, 0)]],                     # no slab
    [],                                          # no job
], ids=["host_only", "no_columns", "some_rows_without", "no_slab",
        "no_job"])
def test_nothing_to_read(read, jobs):
    assert read(_ctx(*jobs)) is None
