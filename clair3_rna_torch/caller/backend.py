"""Pileup backend selection: host C++ tile builder vs the fused device pass.

- "host": the C++ tile builder makes the count image on the host and only
  candidate windows reach the device, which runs the network.
- "fused": packed reads are staged to the device and the whole chunk
  (tilelet expansion, count image, candidate mask, window gather, network,
  prescreen) runs as one device pass (ops/fused_pileup).
- "hybrid": decide PER CHUNK from walls measured during the run
  (ChunkRoutePolicy): each chunk goes to the route with the lower measured
  per-chunk wall in its depth bucket, the loser is re-tried on a bounded
  cadence, and a static cost model over the chunk's BAI-byte span and the
  probed host-to-device link only steers buckets with no measurement yet.
- "auto": "host" until both routes have been measured on the GPU at
  realistic scale and a rule can be drawn from the measurements.

Both routes emit identical VCF rows, so any mix of routes merges exactly.
"""

import logging
import math
import os
import threading
import time

logger = logging.getLogger(__name__)


def _env(name, default, cast=float):
    return cast(os.environ.get("CLAIR3_RNA_TORCH_" + name, default))


# --- ChunkRoutePolicy cost-model PRIOR constants -----------------------------
# The JAX package's constants, fitted to its measured per-chunk walls; on a
# GPU they only have to order two costs in buckets with no measured wall
# yet (the router then follows in-run measurements), and each can be set
# through its CLAIR3_RNA_TORCH_* variable:
#
#   host_s(chunk)  = HOST_FIX_S_PER_POS * width + bases / HOST_BUILD_BPS
#   fused_s(chunk) = FUSED_FIX_S + bases / PACKED_EXTRACT_BPS
#                    + bases * WIRE_BYTES_PER_BASE / link_bps
#   route fused iff fused_s <= host_s * FUSED_PREFERENCE
H_FIX_S_PER_POS = _env("HOST_FIX_S_PER_POS", 0.6e-6)
HOST_BUILD_BPS = _env("HOST_BUILD_BPS", 350e6)
PACKED_EXTRACT_BPS = _env("PACKED_EXTRACT_BPS", 55e6)
FUSED_FIX_S = _env("FUSED_FIX_S", 0.01)
FUSED_PREFERENCE = _env("FUSED_PREFERENCE", 1.25)
WIRE_BYTES_PER_BASE = _env("WIRE_BYTES_PER_BASE", 1.0)
# bases-per-compressed-BAM-byte seed before any chunk has calibrated it
# (~0.5 measured on the test corpus), refined by an EWMA as chunks complete
BASES_PER_CBYTE_SEED = _env("BASES_PER_CBYTE", 0.6)
# re-try a bucket's measured-losing route every N chunks (scaled by the
# measured gap): at a 2x gap the exploration overhead is ~(2-1)/N = 4%
ROUTE_EXPLORE_EVERY = _env("ROUTE_EXPLORE_EVERY", "25", int)
# a bucket whose other route has never been measured tries it much sooner,
# so small runs learn the day's regime inside one pass; after a fused
# failure in a bucket its fused probes back off, doubling the wait per
# failure
ROUTE_PROBE_AFTER = _env("ROUTE_PROBE_AFTER", "4", int)


def probe_link_bandwidth(device, nbytes=50_000_000):
    """Measured host-to-device bandwidth (bytes/s) of one warm copy.

    On a card: one copy of `nbytes` from pinned host memory, timed between
    two CUDA events after a warm-up copy (the first pays allocator setup).
    On the CPU: one plain tensor copy of the same size, timed on the host
    clock (the only "link" there)."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        src = torch.zeros(nbytes, dtype=torch.uint8, pin_memory=True)
        dst = torch.empty(nbytes, dtype=torch.uint8, device=device)
        dst.copy_(src, non_blocking=True)
        start, stop = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        start.record()
        dst.copy_(src, non_blocking=True)
        stop.record()
        stop.synchronize()
        return nbytes / max(start.elapsed_time(stop) / 1e3, 1e-9)
    src = torch.zeros(nbytes, dtype=torch.uint8)
    dst = torch.empty_like(src)
    dst.copy_(src)
    t0 = time.perf_counter()
    dst.copy_(src)
    return nbytes / max(time.perf_counter() - t0, 1e-9)


_LINK_BPS_CACHE: dict = {}
_LINK_LOCK = threading.Lock()


def cached_link_bandwidth(device):
    """probe_link_bandwidth once per process and device type: the probe
    allocates 50 MB of pinned memory, which a run must not pay per call."""
    import torch

    key = torch.device(device).type
    with _LINK_LOCK:
        if key not in _LINK_BPS_CACHE:
            _LINK_BPS_CACHE[key] = probe_link_bandwidth(device)
        return _LINK_BPS_CACHE[key]


class ChunkRoutePolicy:
    """Per-chunk host-vs-fused routing for --pileup_backend hybrid.

    A chunk's aligned-base count is estimated from the compressed BAM bytes
    its region spans in the BAI (io/bai.py), times a bases-per-compressed-
    byte ratio that starts at a seed and is EWMA-calibrated from every
    completed chunk's actual base count (`observe`). Chunks bucket by
    log2(estimated bases); per (bucket, route) the policy keeps an EWMA of
    the measured per-chunk build wall (`observe_wall`; walls that carried a
    one-off cost are discarded).

    - Both routes measured: the measured winner, with the loser re-tried
      every ROUTE_EXPLORE_EVERY chunks scaled by the measured gap.
    - One route measured: its EWMA against the cost model's prior for the
      other route; the cheaper one, with the other probed after
      ROUTE_PROBE_AFTER chunks (fused only once a fused pass has run in the
      process, or the prior puts it within 3x of host).
    - None measured: the cost model's prior.

    Three guards sit on top. Until the first fused chunk has finished (its
    wall recorded, discarded as a one-off, or a failure), at most one chunk
    is routed fused at a time. A fused failure (the fused pass handed the
    chunk back to the host) backs off fused routing in its bucket: fused is
    taken again only after ROUTE_PROBE_AFTER * 2^(failures - 1) chunks, and
    a recorded fused wall clears the count. `observe_wall` files a wall
    under the bucket that `route` chose for that chunk, not one
    re-estimated from a ratio that has moved since.

    Thread-safe: the pipeline's two prefetch threads call route/observe*.
    Routing depends on the order in which chunks complete, so it is not
    deterministic across runs; the merged rows are, since both routes emit
    the same rows.
    """

    def __init__(self, bam_path, link_bps, ref_index):
        from clair3_rna_torch.io.bai import BaiIndex, index_path_for

        self.link_bps = float(link_bps)
        self.ref_index = ref_index
        self.bases_per_cbyte = BASES_PER_CBYTE_SEED
        self.fused_chunks = 0
        self.host_chunks = 0
        self.explore_chunks = 0
        self.fused_failures = 0
        # bucket -> route -> [ewma_wall_s, n_obs]; bucket -> chunks since
        # the measured loser (or unmeasured route) was last tried
        self._walls: dict = {}
        self._since_alt: dict = {}
        # bucket -> [fused failures since the last fused wall, chunks
        # routed since the last failure]
        self._failed: dict = {}
        # (ctg, start, end) -> the bucket route() chose, for observe_wall
        self._routed: dict = {}
        # cold start: fused chunks routed and not yet finished, and whether
        # any fused chunk has finished
        self._fused_pending = 0
        self._fused_settled = False
        self._lock = threading.Lock()
        self._bai = None
        bai_path = index_path_for(bam_path) if bam_path else None
        if bai_path and os.path.exists(bai_path):
            try:
                self._bai = BaiIndex.load(bai_path)
            except Exception:
                logger.warning("[WARNING] hybrid backend: unreadable BAI "
                               "index %s; routing all chunks to host",
                               bai_path)

    @property
    def usable(self):
        return self._bai is not None

    def region_cbytes(self, ctg, start, end):
        """Compressed BAM bytes whose records may overlap [start, end): the
        BAI chunk spans' compressed-offset extent (merged)."""
        rid = self.ref_index.get(ctg)
        if self._bai is None or rid is None:
            return None
        total = 0
        for vbeg, vend in self._bai.query(rid, start, end):
            # virtual offset = coffset << 16 | uoffset; spans are merged by
            # BGZF block already, so coffset deltas do not double-count
            total += max((vend >> 16) - (vbeg >> 16), 0)
        return total

    def estimate_bases(self, ctg, start, end):
        cb = self.region_cbytes(ctg, start, end)
        if cb is None:
            return None
        with self._lock:
            ratio = self.bases_per_cbyte
        return cb * ratio

    @staticmethod
    def _bucket(bases):
        """log2 depth bucket: chunks within one bucket differ <= 2x in
        bases, so raw wall EWMAs compare fairly inside it."""
        return max(0, int(math.log2(max(bases, 1.0) / 1e5)))

    def _model_costs(self, width, bases):
        """Static cost-model prior (constants above): (choice, host_s,
        fused_s)."""
        host_s = H_FIX_S_PER_POS * width + bases / HOST_BUILD_BPS
        fused_s = (FUSED_FIX_S + bases / PACKED_EXTRACT_BPS
                   + bases * WIRE_BYTES_PER_BASE / self.link_bps)
        choice = "fused" if fused_s <= host_s * FUSED_PREFERENCE else "host"
        return choice, host_s, fused_s

    def route(self, ctg, start, end):
        """-> "fused" | "host" for one chunk (see the class docstring)."""
        bases = self.estimate_bases(ctg, start, end)
        if bases is None:
            with self._lock:
                self.host_chunks += 1
            return "host"
        width = end - start
        model_pick, model_host_s, model_fused_s = self._model_costs(
            width, bases)
        model = {"host": model_host_s, "fused": model_fused_s}
        b = self._bucket(bases)
        with self._lock:
            walls = self._walls.get(b, {})
            measured = {r: w[0] for r, w in walls.items() if w[1] > 0}
            self._since_alt[b] = self._since_alt.get(b, 0) + 1
            explored = False
            if len(measured) == 2:
                choice = min(measured, key=measured.get)
                # the cadence scales with the measured gap, so exploration
                # stays ~(r-1)/(EXPLORE_EVERY*r) <= 4% of chunks
                ratio = max(measured.values()) / max(min(measured.values()),
                                                     1e-9)
                if self._since_alt[b] >= ROUTE_EXPLORE_EVERY * max(1.0,
                                                                   ratio):
                    choice = "fused" if choice == "host" else "host"
                    explored = True
            elif len(measured) == 1:
                (known,) = measured
                other = "fused" if known == "host" else "host"
                # the measured wall against the prior for the other route,
                # with the prior's own preference for fused
                fused_s = measured["fused"] if known == "fused" \
                    else model["fused"]
                host_s = measured["host"] if known == "host" \
                    else model["host"]
                choice = "fused" if fused_s <= host_s * FUSED_PREFERENCE \
                    else "host"
                if choice == known and self._since_alt[b] \
                        >= ROUTE_PROBE_AFTER:
                    # a cold fused pass is only bought when a fused pass has
                    # run in the process or the prior puts fused within 3x
                    if other == "host" or self.fused_chunks > 0 \
                            or model_fused_s < 3.0 * model_host_s:
                        choice = other
                        explored = True
                elif choice == other:
                    explored = True
            else:
                choice = model_pick
            failed = self._failed.get(b)
            if failed is not None:
                failed[1] += 1
                if choice == "fused" and failed[0] and failed[1] \
                        < ROUTE_PROBE_AFTER * 2 ** (failed[0] - 1):
                    choice, explored = "host", False
            if choice == "fused" and not self._fused_settled \
                    and self._fused_pending > 0:
                choice, explored = "host", False
            if explored:
                self.explore_chunks += 1
                self._since_alt[b] = 0
            if choice == "fused":
                self.fused_chunks += 1
                self._fused_pending += 1
            else:
                self.host_chunks += 1
            self._routed[(ctg, start, end)] = b
        return choice

    def observe(self, ctg, start, end, actual_bases):
        """Calibrate bases-per-compressed-byte from a completed chunk."""
        cb = self.region_cbytes(ctg, start, end)
        if not cb or actual_bases <= 0:
            return
        ratio = actual_bases / cb
        with self._lock:
            self.bases_per_cbyte = (0.7 * self.bases_per_cbyte
                                    + 0.3 * ratio)

    def _settle_fused(self):
        self._fused_pending = max(self._fused_pending - 1, 0)
        self._fused_settled = True

    def _bucket_of(self, ctg, start, end):
        """The bucket route() chose for the chunk (re-estimated for a chunk
        that was never routed)."""
        with self._lock:
            b = self._routed.pop((ctg, start, end), None)
        if b is None:
            bases = self.estimate_bases(ctg, start, end)
            if not bases or bases <= 0:
                return None
            b = self._bucket(bases)
        return b

    def observe_wall(self, route, ctg, start, end, wall_s, compiled=False):
        """Record a completed chunk's measured build wall for its route.

        Walls of chunks that carried a one-off cost (`compiled`: the fused
        caller's first pass at a budget, or a CUDA library build, detected
        by the pipeline from FusedChunkCaller.one_off_count) are discarded;
        a wall > 20x the bucket's EWMA is clamped there, so one anomaly
        cannot exile a route."""
        b = self._bucket_of(ctg, start, end)
        with self._lock:
            if route == "fused":
                self._settle_fused()
            if wall_s <= 0 or compiled or b is None:
                return
            if route == "fused":
                self._failed.pop(b, None)
            ew = self._walls.setdefault(b, {}).setdefault(route, [0.0, 0])
            if ew[1] > 0:
                wall_s = min(wall_s, 20.0 * ew[0])
            ew[0] = wall_s if ew[1] == 0 else 0.7 * ew[0] + 0.3 * wall_s
            ew[1] += 1

    def observe_failure(self, ctg, start, end):
        """A chunk routed fused came back to the host route (the fused pass
        returned no rows): count it against its bucket's fused probes."""
        b = self._bucket_of(ctg, start, end)
        with self._lock:
            self._settle_fused()
            self.fused_failures += 1
            if b is not None:
                failed = self._failed.setdefault(b, [0, 0])
                failed[0] += 1
                failed[1] = 0

    def counters(self):
        with self._lock:
            return {"fused_chunks": self.fused_chunks,
                    "host_chunks": self.host_chunks,
                    "explore_chunks": self.explore_chunks,
                    "fused_failures": self.fused_failures,
                    "bases_per_cbyte": round(self.bases_per_cbyte, 3),
                    "link_bps": self.link_bps,
                    "bucket_walls": {
                        b: {r: round(w[0], 4) for r, w in rw.items()}
                        for b, rw in sorted(self._walls.items())}}


def choose_backend():
    """-> (backend, reason) for --pileup_backend auto."""
    return "host", ("no measured rule yet for choosing the fused route on "
                    "a GPU: on the H100 the warm host route beat the warm "
                    "fused route on the smoke dataset (PERF.md)")


def resolve_backend(requested=None):
    """Final backend from the CLI flag / env var / auto.

    Precedence: explicit argument, then CLAIR3_RNA_TORCH_PILEUP_BACKEND,
    then "host". "device" and "kernel" name the pure-array builder's count
    backends (pileup/builder.py reads the same variable), so at the
    pipeline level they mean "not the fused route"."""
    backend = (requested
               or os.environ.get("CLAIR3_RNA_TORCH_PILEUP_BACKEND")
               or "host")
    if backend == "auto":
        backend, reason = choose_backend()
        logger.info("[INFO] pileup backend auto-selected: %s (%s)",
                    backend, reason)
    if backend in ("device", "kernel"):
        return "host"
    if backend not in ("host", "fused", "hybrid"):
        raise ValueError(f"bad pileup backend: {backend!r} "
                         "(expected auto|host|fused|hybrid)")
    return backend
