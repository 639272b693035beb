#!/usr/bin/env python3
"""The benchmark of clair3_rna_torch: one run of one cell.

    python3 callbench/run.py --workload <name> --seed <n> --seconds <s> --trace 0|1

Set-up (timed as setup_s, from the process's start): the program's
libraries (built into its _build/ directories on a checkout's first run),
the configuration's load (its weights onto the card), the traffic's
contigs simulated from the seed in child processes under TMPDIR, each
BAM's index, and the warm-up jobs. Then the window: the configuration's
jobs of one contig each, back to back, for --seconds (the job running at
the close finishes inside the window). With --trace 1, one more job runs
under torch.profiler after the window. Last, the configuration's check:
the plain reference (callbench/reference) is computed from the seed and
compared with what the window's jobs produced.

A cell, its configuration, traffic and per-layer metrics are found by the
names in BENCHMARK.json: callbench/cells/<cell>.json,
callbench/configs/<config>.json with callbench/configs/<config>.py (its
load, job and check), callbench/traffic/<traffic>.json and
callbench/metrics/<metric>.py. So a new cell, and a new configuration, is
new files and entries.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics with --trace 0, its
per-layer metrics with --trace 1), device, breakdown (--trace 1) and
checks (each compared number beside its limit). Without a CUDA card, or
with fewer cards than the cell asks for, it prints no result and exits 3.
"""

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from callbench import harness  # noqa: E402
from callbench.lib.guard import forbidden_modules  # noqa: E402


def _cache_env(root):
    """The program's kernel caches inside the checkout, at fixed paths."""
    cache = os.path.join(root, ".callbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ.pop("CLAIR3_RNA_TORCH_PROFILE", None)


def metric_reader(name, root=ROOT):
    """The read(ctx) function of callbench/metrics/<name>.py."""
    path = os.path.join(root, "callbench", "metrics", name + ".py")
    return harness.file_module(path, "callbench_metric_" + name).read


def limits_for(workload, root=ROOT):
    return harness.cell_file(workload, root)["limits"]


def measure(workload, seed, seconds, trace, device="cuda", root=ROOT):
    """One run -> the result dict (without the guard's verdict)."""
    import torch

    cell = harness.Cell(workload, seed, device=device, root=root, trace=trace)
    try:
        cell.setup()
        setup_s = harness.process_age_s()
        cap = harness.Capture()
        failed = 0
        try:
            window_s, rss = cell.window(seconds, capture=cap)
        except Exception:  # noqa: BLE001  (reported; the run is not correct)
            import traceback
            traceback.print_exc()
            failed, window_s, rss = 1, None, None
        finally:
            cap.close()
        cuda = torch.device(device).type == "cuda"
        dev = {"platform": "gpu" if cuda else "cpu",
               "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
               "count": 1,
               "memory_peak_bytes": torch.cuda.max_memory_allocated(0)
               if cuda else 0}
        activity = cell.profiled_job() if trace and not failed else None
        for job in cell.jobs:
            job["joblog_rows"] = [harness.read_joblog(p) for p in job["joblog"]]
            if "captured" in job:
                job["captured"] = harness.host_rows(job["captured"])
        cell.state = None
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        t = time.perf_counter()
        numbers, check_parts = cell.config_module.check(cell, device)
        check_s = time.perf_counter() - t
        limits = limits_for(workload, root)
        checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
        correct = not failed and bool(cell.jobs) and all(
            c["value"] <= c["limit"] for c in checks.values())

        gbases = sum(j["read_bases"] for j in cell.jobs) / 1e9
        if not trace:
            metrics = {
                "mbases_per_s": {"value": gbases * 1e3 / window_s
                                 if window_s else 0.0, "unit": "Mbases/s"},
                "peak_rss_gb": {"value": (rss or 0) / 1e9, "unit": "GB"},
                "setup_s": {"value": setup_s, "unit": "s"},
            }
        else:
            ctx = {"jobs": cell.jobs, "window_s": window_s, "gbases": gbases,
                   "activity": activity, "cfg": cell.cfg,
                   "traffic": cell.traffic}
            metrics = {}
            for m in cell.bench["per_layer"]:
                if "workloads" in m and workload not in m["workloads"]:
                    continue
                value = metric_reader(m["name"], root)(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result = {"correct": correct, "attempted": len(cell.jobs) + failed,
                  "failed": failed, "metrics": metrics, "device": dev}
        if activity is not None:
            dev["busy_s"] = activity["busy_s"]
            dev["window_s"] = activity["window_s"]
            result["breakdown"] = {"device_ops": activity["device_ops"],
                                   "idle_gaps": activity["idle_gaps"]}
        result["setup_parts"] = dict(cell.parts, setup_s=setup_s,
                                     window_s=window_s, check_s=check_s,
                                     **check_parts,
                                     jobs=len(cell.jobs),
                                     jobs_s=[[j["end_s"], j["cpu_s"],
                                              j["stats"][0]["build_s"],
                                              j["stats"][0]["decode_s"],
                                              j["stats"][0]["candidates"]]
                                             for j in cell.jobs])
        result["checks"] = checks
        return result
    finally:
        cell.close()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    cell, _, _, _ = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"callbench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    _cache_env(ROOT)
    result = measure(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"callbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
