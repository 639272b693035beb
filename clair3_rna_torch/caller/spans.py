"""Spans: where a calling run's host time goes, on the clocks the joblog and
the profiler's trace share.

`span(name)` times a stretch of work with time.perf_counter_ns(). Inside a
`Chunk` record (one chunk's build on a prefetch thread) it adds its duration
to that chunk's totals, which the pipeline sums into CallStats and the
joblog. While a torch.profiler records, the span is also a
torch.profiler.record_function range on the thread that did the work, so
it sits on the trace's own clock. Without a profiler a span costs its two
perf_counter_ns reads (and a dict update inside a chunk).
"""

import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

_local = threading.local()


def profiling():
    """True while a torch.profiler records. The module-level flag is set
    under the default and the all-threads configuration alike; the
    per-thread torch._C._autograd._profiler_enabled() reads false under
    the latter."""
    return _autograd_profiler._is_profiler_enabled


class Chunk:
    """The spans and counters of one chunk: its record, made on the thread
    that builds it."""

    def __init__(self):
        self.thread = threading.current_thread().name
        self.start_epoch_ns = time.time_ns()  # the trace's clock
        self.totals = {}                      # span name -> summed ns
        self.counters = {}

    def add(self, name, ns):
        self.totals[name] = self.totals.get(name, 0) + ns

    def seconds(self, name):
        return self.totals.get(name, 0) / 1e9

    def __enter__(self):
        self._outer = getattr(_local, "chunk", None)
        _local.chunk = self
        return self

    def __exit__(self, *exc):
        _local.chunk = self._outer
        return False


class span:
    """`with span(name):` times the block into the current chunk's record
    (if any) and, while a profiler records and `profile` is set, makes it a
    record_function range. start()/stop() do the same for a stretch that
    no block encloses; stop() is a no-op on a span that is not running.
    `seconds` is the span's duration once stopped."""

    __slots__ = ("name", "profile", "start_ns", "end_ns", "_chunk",
                 "_running", "_range")

    def __init__(self, name, profile=True):
        self.name = name
        self.profile = profile
        self.start_ns = self.end_ns = 0
        self._running = False
        self._range = None

    def start(self):
        self._chunk = getattr(_local, "chunk", None)
        self._running = True
        if self.profile and profiling():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def stop(self):
        if not self._running:
            return
        self.end_ns = time.perf_counter_ns()
        self._running = False
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        if self._chunk is not None:
            self._chunk.add(self.name, self.end_ns - self.start_ns)

    __enter__ = start

    def __exit__(self, *exc):
        self.stop()
        return False

    def elapsed(self):
        """Seconds since start(), while the span runs."""
        return (time.perf_counter_ns() - self.start_ns) / 1e9

    @property
    def seconds(self):
        return (self.end_ns - self.start_ns) / 1e9


def count(name, n=1):
    """Add n to a counter of the current chunk's record (no chunk: no-op)."""
    rec = getattr(_local, "chunk", None)
    if rec is not None:
        rec.counters[name] = rec.counters.get(name, 0) + n


def note(**values):
    """Set counters of the current chunk's record (no chunk: no-op)."""
    rec = getattr(_local, "chunk", None)
    if rec is not None:
        rec.counters.update(values)
