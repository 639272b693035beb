"""One run of one cell: set-up, the measured window, the traced slice and the
check of what the window produced.

A cell names a configuration (callbench/configs/<config>.json) and a
traffic mix (callbench/traffic/<traffic>.json), and has a file of its own,
callbench/cells/<cell>.json: the program's `call` options it runs with and
the limits of its check. What a configuration's job runs and how its output
is checked sit beside its JSON in callbench/configs/<config>.py, as three
functions: load(cell) (weights and settings, timed in set-up), job(cell,
contig, out_dir, joblog) (one job of one contig) and check(cell, device)
(the plain reference's numbers). All are found by the names in
BENCHMARK.json, so a new cell, and a new configuration, is new files and
entries. The window drives the configuration's job, one contig a job, back
to back (a closed loop of one caller, as one shard of a sharded `call`
processes contigs). Every job writes into a fresh directory.
"""

import importlib.util
import json
import os
import shutil
import tempfile
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# share of the window's jobs whose network rows are kept for the check
CAPTURE_SHARE = 0.25


def load_cell(workload, root=ROOT):
    """(workload entry, configuration dict, traffic dict, benchmark dict)."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    cell = cells[workload]
    with open(os.path.join(root, "callbench", "configs",
                           cell["config"] + ".json")) as f:
        cfg = json.load(f)
    with open(os.path.join(root, "callbench", "traffic",
                           cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return cell, cfg, traffic, bench


def file_module(path, name):
    """The Python file at `path`, imported as module `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def config_module(config, root=ROOT):
    """callbench/configs/<config>.py, with its load, job and check."""
    path = os.path.join(root, "callbench", "configs", config + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"configuration {config!r} has no {path}")
    return file_module(path, "callbench_config_" + config)


def cell_file(workload, root=ROOT):
    """callbench/cells/<workload>.json: {"call": the program's `call` options,
    "limits": {number: limit}, ...}."""
    with open(os.path.join(root, "callbench", "cells", workload + ".json")) as f:
        return json.load(f)


def process_age_s():
    """Seconds since this process started, from /proc."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


class PeakRss:
    """Peak resident memory of this process over a stretch of time: the
    kernel's high-water mark after a reset (/proc/self/clear_refs), or,
    where the reset is refused, a 20 ms sampler of VmRSS."""

    def __init__(self):
        self.peak = 0
        self._stop = None

    @staticmethod
    def _status(key):
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith(key):
                    return int(line.split()[1]) * 1024
        return 0

    def start(self):
        try:
            with open("/proc/self/clear_refs", "w") as f:
                f.write("5")
            return self
        except OSError:
            pass
        self._stop = threading.Event()

        def sample():
            while not self._stop.wait(0.02):
                self.peak = max(self.peak, self._status("VmRSS:"))
        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._stop is None:
            return self._status("VmHWM:")
        self._stop.set()
        self._thread.join()
        return max(self.peak, self._status("VmRSS:"))


class Capture:
    """The rows the program's network takes and gives (PileupNet calls),
    kept while `on`, from any thread."""

    def __init__(self):
        import torch
        self.on = False
        self.rows = []
        self._handle = torch.nn.modules.module.register_module_forward_hook(
            self._hook)

    def _hook(self, module, inputs, output):
        if self.on and type(module).__name__ == "PileupNet":
            self.rows.append((inputs[0].detach(), output.detach()))

    def take(self):
        """The rows kept so far (device tensors), and clear."""
        rows, self.rows = self.rows, []
        return rows

    def close(self):
        self._handle.remove()


def host_rows(rows):
    """Kept (x, p) pairs -> {channels: (x int32 [n, 33, C], p float32)}."""
    import torch
    by_ch = {}
    for x, p in rows:
        by_ch.setdefault(x.shape[-1], []).append((x, p))
    out = {}
    for ch, pairs in by_ch.items():
        x = torch.cat([a for a, _ in pairs]).cpu().numpy()
        xi = x.astype(np.int32)
        if not np.array_equal(xi, x):
            raise RuntimeError("network input rows are not integer counts")
        out[ch] = (xi, torch.cat([b for _, b in pairs]).float().cpu().numpy())
    return out


class Cell:
    """Set-up and jobs of one cell on `device`."""

    def __init__(self, workload, seed, device="cuda", root=ROOT,
                 trace=False):
        self.cell, self.cfg, self.traffic, self.bench = load_cell(workload,
                                                                  root)
        self.call = cell_file(workload, root)["call"]
        self.config_module = config_module(self.cell["config"], root)
        self.seed = int(seed)
        self.device = device
        self.root = root
        self.trace = trace
        self.parts = {}
        self.jobs = []
        self.tmp = None
        self.state = None

    # ---------------------------------------------------------------- set-up
    def setup(self):
        """Libraries, weights and data (made in children meanwhile), then
        the warm-up jobs."""
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        self.parts["start_s"] = process_age_s()
        self.tmp = tempfile.mkdtemp(prefix="callbench-")
        data = os.path.join(self.tmp, "data")
        os.makedirs(data, exist_ok=True)
        t0 = time.perf_counter()
        n = int(self.traffic["contigs"])
        pool = ProcessPoolExecutor(
            max_workers=min(n, os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn"))
        from callbench.gen.bam import write_sample
        futs = [pool.submit(write_sample, self.traffic, self.seed, i, data)
                for i in range(n)]
        try:
            t = time.perf_counter()
            self._libraries()
            self.parts["libraries_s"] = time.perf_counter() - t
            t = time.perf_counter()
            self.state = self.config_module.load(self)
            self.parts["weights_s"] = time.perf_counter() - t
            t = time.perf_counter()
            self.contigs = [f.result() for f in futs]
            self.parts["generation_wait_s"] = time.perf_counter() - t
            self.parts["generation_s"] = time.perf_counter() - t0
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
        t = time.perf_counter()
        from clair3_rna_torch.pileup.chunk import open_bam
        for c in self.contigs:  # each BAM's index, as a call's first open
            open_bam(c["bam"]).close()
        for k in range(n):  # every contig once: the shapes the window uses
            self.job(self.contigs[k], tag=f"warm{k}")
        self._sync()
        # the data and the warm-up's outputs reach the disk now, not as
        # background writeback inside the window
        os.sync()
        self.parts["warmup_s"] = time.perf_counter() - t

    def _libraries(self):
        import torch
        import clair3_rna_torch  # noqa: F401  (sets TF32 off)
        from clair3_rna_torch.caller import pipeline  # noqa: F401
        from clair3_rna_torch.native import get_library
        if torch.device(self.device).type == "cuda":
            from clair3_rna_torch import csrc
            csrc.build_all()
            torch.zeros(1, device=self.device)
        get_library()

    def _sync(self):
        import torch
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()

    # ------------------------------------------------------------------ jobs
    def job(self, contig, tag, joblog=False):
        """The configuration's job of one contig in a fresh directory ->
        record."""
        out = os.path.join(self.tmp, "jobs", tag)
        shutil.rmtree(out, ignore_errors=True)
        os.makedirs(out)
        rec = self.config_module.job(self, contig, out, joblog)
        self._sync()
        return rec

    def job_order(self):
        """Contig of each window job: every round visits each contig once,
        in an order drawn from the seed."""
        rng = np.random.default_rng(np.random.SeedSequence(
            [self.seed & (2**63 - 1), 99]))
        n = len(self.contigs)
        while True:
            yield from rng.permutation(n).tolist()

    def window(self, seconds, capture=None):
        """Jobs back to back until `seconds` have passed; the window closes
        when the job running then ends -> (window seconds, peak RSS bytes)."""
        rng = np.random.default_rng(np.random.SeedSequence(
            [self.seed & (2**63 - 1), 98]))
        order = self.job_order()
        seen = set()
        rss = PeakRss().start()
        t0 = time.perf_counter()
        k = 0
        while time.perf_counter() - t0 < seconds:
            c0 = os.times()
            i = next(order)
            sample = rng.random() < CAPTURE_SHARE or i not in seen
            seen.add(i)
            if capture is not None:
                capture.on = sample
            rec = self.job(self.contigs[i], tag=f"job{k}", joblog=self.trace)
            if capture is not None:
                capture.on = False
                if sample:
                    rec["captured"] = capture.take()
            rec["end_s"] = time.perf_counter() - t0
            c1 = os.times()
            rec["cpu_s"] = c1.user + c1.system - c0.user - c0.system
            self.jobs.append(rec)
            k += 1
        window_s = time.perf_counter() - t0
        return window_s, rss.stop()

    def profiled_job(self):
        """One more job, of the first contig in the job order, under
        torch.profiler -> device activity of its trace."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        from callbench.lib.trace import device_activity
        acts = [ProfilerActivity.CPU]
        if torch.device(self.device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        i = next(self.job_order())
        with profile(activities=acts) as prof:
            rec = self.job(self.contigs[i], tag="profiled")
        path = os.path.join(self.tmp, "trace.json")
        prof.export_chrome_trace(path)
        act = device_activity(path)
        os.remove(path)
        if act is not None:
            act["job"] = rec
        return act

    def close(self):
        if self.tmp and os.path.isdir(self.tmp):
            shutil.rmtree(self.tmp, ignore_errors=True)


def stats_dict(stats):
    """A pass's CallStats as the record's plain dict."""
    return {"build_s": stats.build_s, "infer_s": stats.infer_s,
            "decode_s": stats.decode_s, "candidates": stats.candidates,
            "decoded": stats.decoded, "rows": stats.rows,
            "wall_s": stats.wall_s, "phase_s": stats.phase_s,
            "routing": dict(stats.routing) if stats.routing else None,
            "fused": dict(stats.fused) if stats.fused else None}


def read_joblog(path):
    """Per-chunk rows of a pass's joblog (the program's per-chunk TSV)."""
    rows = []
    with open(path) as f:
        head = f.readline().rstrip("\n").split("\t")
        for line in f:
            rows.append(dict(zip(head, line.rstrip("\n").split("\t"))))
    return rows
