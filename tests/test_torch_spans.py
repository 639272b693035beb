"""The port's spans (clair3_rna_torch/caller/spans.py) and what they feed:
the joblog's columns, CallStats, and the ranges of a
CLAIR3_RNA_TORCH_PROFILE trace. Runs the port's run_calling on the CPU on
a small simulated dataset, traced (a joblog and a profile) and untraced,
on the host route, the fused route and the fused route with splice
padding (whose first chunk falls back to the host build); the VCF bodies
are held to the JAX package's host route."""

import json
import os
import random
import threading

import pytest
import torch

from clair3_rna_torch.caller import spans

# one intra-op thread: the suite runs six worker processes on a
# shared host, where PyTorch's spinning thread pools oversubscribe it
torch.set_num_threads(1)

HEADER = ("contig\tstart\tend\tcandidates\tbuild_seconds\troute\tworker"
          "\tstarttime\tdonetime\twait_s\textract_s\tstage_s\th2d_s"
          "\tlaunch_s\tsync_s\tescape_s\tdecode_s\tstaged_rows\tk1_bytes"
          "\tbudget\tretries\tnet_slabs\tnet_graph_slabs")
STAGES = ("extract_s", "stage_s", "h2d_s", "launch_s", "sync_s", "escape_s",
          "decode_s")
CHUNK = 10_000


def _body(path):
    return [line for line in open(path) if not line.startswith("#")]


def _rows(path):
    with open(path) as f:
        lines = f.read().splitlines()
    head = lines[0].split("\t")
    return lines[0], [dict(zip(head, ln.split("\t"))) for ln in lines[1:]]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Seed 41: chr1 30 kb, 100 variants, depth 30, a 14-16 kb splice; the
    port's init_params(0) as npz. Port runs (traced: joblog and profile;
    untraced: neither, record_function counted) of the host route, the
    fused route and the fused route with splice padding; the JAX host
    route's body."""
    from clair3_rna_torch import simdata
    from clair3_rna_torch.caller.decode import CallConfig
    from clair3_rna_torch.caller.pipeline import run_calling
    from clair3_rna_torch.config import PileupConfig
    from clair3_rna_torch.io.fasta import write_fasta
    from clair3_rna_torch.models.network import (init_params,
                                                 make_wire_forward_fn)
    from clair3_rna_torch.models.params_io import (load_params,
                                                   params_from_numpy,
                                                   save_params)
    from clair3_rna_torch.ops import fused_pileup, tilelet
    from tests.torch_jax_host import jax_host_body

    d = tmp_path_factory.mktemp("spans")
    rng = random.Random(41)
    genome = simdata.random_genome(rng, [("chr1", 30_000)])
    variants = simdata.plant_variants(rng, genome, n_per_contig=100)
    fasta, bam = str(d / "ref.fa"), str(d / "reads.bam")
    write_fasta(fasta, genome)
    simdata.simulate_bam(bam, genome, variants, rng, depth=30,
                         splice_sites={"chr1": [(14_000, 16_000)]})
    tree = load_params(save_params(str(d / "w.npz"),
                                   init_params(0, device="cpu")))
    params = params_from_numpy(tree, device="cpu")
    _, forward = make_wire_forward_fn()
    out = {"jax": jax_host_body(bam, fasta, str(d / "jax.vcf"), tree,
                                chunk_size=CHUNK)[0]}
    staged = {}  # chunk start -> (staged rows, kernel_bytes)
    real_stage = fused_pileup.stage_chunk_packed

    def stage(*a, **k):
        st = real_stage(*a, **k)
        staged[st.start + st.core_lo] = (int(st.tl_row_off[-1]),
                                         tilelet.kernel_bytes(st))
        return st

    ranges = []

    def counted_range(name):
        ranges.append(name)
        return real_range(name)

    real_range = torch.profiler.record_function
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CLAIR3_RNA_TORCH_NATIVE_THREADS", "1")
        mp.setenv("CLAIR3_RNA_TPU_NATIVE_THREADS", "1")
        mp.setattr(fused_pileup, "stage_chunk_packed", stage)
        for name, backend, splice in (("host", "host", False),
                                      ("fused", "fused", False),
                                      ("splice", "fused", True)):
            cfg = PileupConfig(batch_size=2048, enable_splice_padding=splice)
            for traced in (True, False):
                tag = f"{name}_{'on' if traced else 'off'}"
                if traced:
                    mp.setenv("CLAIR3_RNA_TORCH_PROFILE", str(d / tag))
                else:
                    mp.delenv("CLAIR3_RNA_TORCH_PROFILE", raising=False)
                    mp.setattr(torch.profiler, "record_function",
                               counted_range)
                joblog = str(d / f"{tag}.tsv")
                outputs, stats = run_calling(
                    bam, fasta, str(d / f"{tag}.vcf"), cfg=cfg,
                    call_cfg=CallConfig(show_ref=False), params=params,
                    forward=forward, chunk_size=CHUNK, compress=False,
                    progress=False, joblog=joblog if traced else None,
                    pileup_backend=backend, device="cpu")
                mp.setattr(torch.profiler, "record_function", real_range)
                out[tag] = {"body": _body(outputs[0]), "stats": stats,
                            "joblog": joblog, "profile": d / tag}
    out["staged"] = staged
    out["untraced_ranges"] = ranges
    return out


def test_joblog_header_routes_and_candidates(runs):
    """The exact header; every column numeric where it should be; route
    in its three values; the candidates column sums to CallStats'."""
    routes = set()
    for name in ("host", "fused", "splice"):
        head, rows = _rows(runs[f"{name}_on"]["joblog"])
        assert head == HEADER
        assert [int(r["start"]) for r in rows] == [0, 10_000, 20_000]
        for r in rows:
            assert r["route"] in ("fused", "host", "fallback")
            routes.add(r["route"])
            assert r["worker"] in ("0", "1")
            for k in ("start", "end", "candidates", "retries"):
                assert int(r[k]) >= 0, (k, r)
            for k in ("build_seconds", "starttime", "donetime",
                      "wait_s") + STAGES:
                assert float(r[k]) >= 0.0, (k, r)
            staging = ("staged_rows", "k1_bytes", "budget")
            if r["route"] == "host":
                assert all(r[k] == "" for k in staging)
                assert all(float(r[k]) == 0.0 for k in STAGES)
            else:
                assert all(int(r[k]) > 0 for k in staging), r
        assert sum(int(r["candidates"]) for r in rows) \
            == runs[f"{name}_on"]["stats"].candidates > 0
    assert routes == {"fused", "host", "fallback"}
    assert {r["route"] for r in _rows(runs["host_on"]["joblog"])[1]} \
        == {"host"}
    assert {r["route"] for r in _rows(runs["fused_on"]["joblog"])[1]} \
        == {"fused"}


def test_net_slab_counters(runs):
    """A fused-attempted chunk's build ran network slabs (64 rows on the
    CPU: its final pass alone runs budget / 64), none replayed from a
    graph on the CPU; a host chunk's batches run on the main thread and
    count none. The benchmark's reader of the two columns reads 0% from
    the fused runs and nothing from the host run."""
    from callbench.run import metric_reader
    read = metric_reader("net.graph_slab_pct")
    for name in ("host", "fused", "splice"):
        rows = _rows(runs[f"{name}_on"]["joblog"])[1]
        for r in rows:
            assert int(r["net_graph_slabs"]) == 0, r
            if r["route"] == "host":
                assert int(r["net_slabs"]) == 0, r
            else:
                assert int(r["net_slabs"]) >= max(1, int(r["budget"] or 0)
                                                  // 64), r
        share = read({"jobs": [{"joblog_rows": [rows]}]})
        assert share == (None if name == "host" else 0.0), name


def test_fused_stages_within_build_seconds(runs):
    """A fused chunk's seven stage spans lie inside its build: their sum is
    at most build_seconds (+1 ms for the column's rounding)."""
    for name in ("fused", "splice"):
        for r in _rows(runs[f"{name}_on"]["joblog"])[1]:
            if r["route"] != "fused":
                continue
            stages = sum(float(r[k]) for k in STAGES)
            assert 0.0 < stages <= float(r["build_seconds"]) + 1e-3, r
            assert float(r["launch_s"]) > 0.0 and float(r["decode_s"]) > 0.0


def test_start_done_and_wait(runs):
    """starttime <= donetime (epoch seconds), the build inside them, and
    wait_s >= 0; CallStats.build_s is the joblog's build seconds summed."""
    for name in ("host", "fused", "splice"):
        rows = _rows(runs[f"{name}_on"]["joblog"])[1]
        for r in rows:
            start, done = float(r["starttime"]), float(r["donetime"])
            assert start <= done
            assert float(r["build_seconds"]) <= done - start + 1e-3
            assert float(r["wait_s"]) >= 0.0
        assert runs[f"{name}_on"]["stats"].build_s == pytest.approx(
            sum(float(r["build_seconds"]) for r in rows), abs=1e-3)


def test_k1_bytes_is_kernel_bytes_of_the_staged_chunk(runs):
    rows = [r for name in ("fused", "splice")
            for r in _rows(runs[f"{name}_on"]["joblog"])[1]]
    assert rows
    for r in rows:
        want_rows, want_bytes = runs["staged"][int(r["start"])]
        assert int(r["staged_rows"]) == want_rows > 0
        assert int(r["k1_bytes"]) == want_bytes > 0


def test_bodies_equal_traced_untraced_and_jax(runs):
    """Tracing changes no row: bodies equal with tracing on and off, and
    (without splice padding, as the JAX helper runs) the JAX host
    route's."""
    for name in ("host", "fused", "splice"):
        assert runs[f"{name}_on"]["body"] == runs[f"{name}_off"]["body"]
    assert runs["host_on"]["body"] == runs["jax"]
    assert runs["fused_on"]["body"] == runs["jax"]


def test_untraced_runs_write_no_joblog_and_enter_no_range(runs):
    for name in ("host", "fused", "splice"):
        assert not os.path.exists(runs[f"{name}_off"]["joblog"])
        assert not os.path.exists(runs[f"{name}_off"]["profile"])
    assert runs["untraced_ranges"] == []


def test_profile_trace_holds_spans_on_every_thread(runs):
    """A CLAIR3_RNA_TORCH_PROFILE trace of a fused run records chunk.*
    ranges on at least two threads (the prefetch threads), call.head and
    call.tail, and no pipeline.wait range."""
    with open(runs["fused_on"]["profile"] / "trace.json") as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    names = {e["name"] for e in events}
    tids = {e["tid"] for e in events if e["name"].startswith("chunk.")}
    assert len(tids) >= 2
    assert {"chunk", "chunk.extract", "chunk.stage", "chunk.h2d",
            "chunk.launch", "chunk.sync", "chunk.escape", "chunk.decode",
            "call.head", "call.tail"} <= names
    assert "pipeline.wait" not in names


def test_span_records_nest_and_count():
    """A chunk's record sums each span's time by name, nested spans too;
    counters act on the current chunk only; a span outside a chunk only
    times, and stop() on a span stopped or never started is a no-op."""
    spans.count("retries")  # no chunk: no-op
    with spans.Chunk() as rec:
        with spans.span("chunk") as whole:
            with spans.span("chunk.stage") as inner:
                spans.note(staged_rows=7)
            with spans.span("chunk.stage") as again:
                pass
            spans.count("retries")
            spans.count("retries")
    with spans.span("call.tail") as outside:
        pass
    assert rec.thread == threading.current_thread().name
    assert set(rec.totals) == {"chunk", "chunk.stage"}
    # in integer ns: the sum of two float seconds may round off the total's
    assert rec.totals["chunk.stage"] == (inner.end_ns - inner.start_ns) \
        + (again.end_ns - again.start_ns)
    assert whole.start_ns <= inner.start_ns <= inner.end_ns <= whole.end_ns
    assert rec.seconds("chunk") == whole.seconds >= rec.seconds("chunk.stage")
    assert rec.counters == {"staged_rows": 7, "retries": 2}
    assert outside.seconds >= 0.0 and "call.tail" not in rec.totals
    end_ns = whole.end_ns
    whole.stop()
    spans.span("never").stop()
    assert whole.end_ns == end_ns and set(rec.totals) == {"chunk",
                                                          "chunk.stage"}


def test_failed_run_leaves_no_range_open(tmp_path):
    """A run_calling that raises in its set-up closes call.head as it
    raises: under a profiler that records on, the range ends before the
    next one starts. An open range would run on to the profiler's stop
    while anything holds the failed run's frame (here, its traceback)."""
    from clair3_rna_torch.caller.pipeline import _profiler, run_calling

    prof = _profiler(torch.device("cpu"))
    with prof:
        with pytest.raises(FileNotFoundError) as failure:
            run_calling(str(tmp_path / "missing.bam"),
                        str(tmp_path / "missing.fa"),
                        str(tmp_path / "o.vcf"), device="cpu",
                        progress=False)
        with torch.profiler.record_function("after"):
            pass
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(tmp_path / "trace.json") as f:
        events = {e["name"]: e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"}
    head, after = events["call.head"], events["after"]
    assert head["ts"] + head["dur"] <= after["ts"]
    assert "call.tail" not in events
    assert failure.tb is not None


def test_profiling_flag_seen_from_worker_threads():
    """spans.profiling() reads true on a thread the profiler did not start
    from, and a span there becomes a range under the all-threads
    configuration."""
    from clair3_rna_torch.caller.pipeline import _profiler

    seen = []

    def work():
        seen.append(spans.profiling())
        with spans.span("chunk.stage"):
            pass

    assert not spans.profiling()
    prof = _profiler(torch.device("cpu"))
    with prof:
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    assert seen == [True]
    assert "chunk.stage" in {e.key for e in prof.key_averages()}
