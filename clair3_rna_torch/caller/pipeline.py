"""End-to-end calling pipeline: BAM + FASTA -> sorted VCF.

Replaces the reference's process-pipe orchestration (GNU parallel spawning
call_var_bam workers that pipe pypy create_tensor_pileup into python
call_variants, run_clair3_rna:668-878) with an in-process streaming design:
chunk planning -> vectorized tensor building -> batched inference on the
device -> host decode -> in-memory merge/sort.
"""

import functools
import logging
import os
import time
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from clair3_rna_torch import config
from clair3_rna_torch.config import PileupConfig
from clair3_rna_torch.caller import spans
from clair3_rna_torch.caller.decode import CallConfig, decode_batch
from clair3_rna_torch.io.fasta import FastaFile
from clair3_rna_torch.pileup.chunk import build_chunk_tensors, plan_chunks
from clair3_rna_torch.postprocess.sort_vcf import load_rediportal, sort_rows
from clair3_rna_torch.task import GT21_LABEL_INDEX

logger = logging.getLogger(__name__)


# hybrid route policies cached per BAM: walls learned by one run_calling
# (repeated runs, the phased second pass on its own tagged BAM) carry to
# the next instead of relearning the regime; CallStats.routing reports the
# run's own chunk counts
_ROUTE_POLICIES: OrderedDict = OrderedDict()
_ROUTE_POLICIES_MAX = 4


def _get_route_policy(bam_path, link_bps, ref_index):
    from clair3_rna_torch.caller.backend import ChunkRoutePolicy

    key = os.path.realpath(bam_path) if bam_path else None
    pol = _ROUTE_POLICIES.get(key)
    if pol is not None:
        _ROUTE_POLICIES.move_to_end(key)
        return pol
    pol = ChunkRoutePolicy(bam_path, link_bps, ref_index)
    _ROUTE_POLICIES[key] = pol
    while len(_ROUTE_POLICIES) > _ROUTE_POLICIES_MAX:
        _ROUTE_POLICIES.popitem(last=False)
    return pol


def _stack_renormed(records, cfg: PileupConfig):
    """TensorRecords -> signed int32 batch [N, 33, C] with the reference's
    high-coverage renormalization (clair3_rna/utils.py:88-92: scale by
    max_depth/depth when depth > 1.5x max_depth, then truncate back to int)."""
    n = len(records)
    channels = cfg.channel_size
    max_depth = config.MAX_DEPTH_BY_PLATFORM.get(cfg.platform, config.MAX_DEPTH)
    X = np.empty((n, config.NO_OF_POSITIONS, channels), dtype=np.int32)
    for i, rec in enumerate(records):
        X[i] = rec.tensor
    depths = np.fromiter((rec.depth for rec in records), dtype=np.int64, count=n)
    renorm = np.nonzero(depths > max_depth * 1.5)[0]
    if len(renorm):
        # float-divide then truncate toward zero, as int assignment does
        X[renorm] = X[renorm] / (depths[renorm, None, None] / max_depth)
    return X


def batch_tensors(records, cfg: PileupConfig):
    """Legacy signed wire: int16 batch for plain forward(params, x) fns.

    Post-renorm magnitudes are bounded by 1.5*max_depth (= 216) at the
    window center; int16 is lossless for any realistic flank depth and
    halves the host->device transfer vs int32."""
    return _stack_renormed(records, cfg).astype(np.int16)


_WIRE_CODE = np.zeros(256, dtype=np.int8)
for _i, _b in enumerate("ACGT"):
    _WIRE_CODE[ord(_b)] = _i


def batch_wire(records, cfg: PileupConfig):
    """TensorRecords -> (wire, codes) for make_wire_forward_fn.

    wire is uint8 channel magnitudes when every |value| fits (the common
    case: magnitudes are bounded by per-row depth, <= 216 after
    renormalization at the center), else signed int16/int32. codes[b, t] is
    the effective reference-base code of window row t (non-ACGT -> A,
    matching evc_base_from), from which the device reconstructs the
    ref-channel negation signs exactly."""
    X = _stack_renormed(records, cfg)
    seq_bytes = np.frombuffer(
        "".join(r.ref_seq for r in records).encode(), dtype=np.uint8)
    codes = _WIRE_CODE[seq_bytes].reshape(len(records), config.NO_OF_POSITIONS)
    mags = np.abs(X)
    peak = int(mags.max()) if len(X) else 0
    if peak <= 255:
        wire = mags.astype(np.uint8)
    elif peak <= 32767:
        wire = X.astype(np.int16)
    else:
        wire = X
    return wire, codes


def prescreen_mask(probabilities: np.ndarray, refseq_list, show_ref: bool):
    """Vectorized homRef early-exit (clair3_rna/call_variants.py:540-542):
    sites certain to be RefCall can skip host decode when RefCalls are not
    printed. Returns a boolean 'needs full decode' mask."""
    if show_ref:
        return np.ones(len(probabilities), dtype=bool)
    gt21 = probabilities[:, :21]
    genotype = probabilities[:, 21:24]
    center = config.FLANKING_BASE_NUM
    ref_idx = np.array([
        GT21_LABEL_INDEX.get(seq[center] * 2 if seq[center] in "ACGT" else "AA", 0)
        for seq in refseq_list], dtype=np.int64)
    ref_gt21_prob = np.take_along_axis(gt21, ref_idx[:, None], axis=1)[:, 0]
    certain_ref = (genotype[:, 0] >= 0.5) & (ref_gt21_prob >= 0.5)
    return ~certain_ref


@dataclass
class CallStats:
    candidates: int = 0
    decoded: int = 0
    rows: int = 0
    build_s: float = 0.0
    infer_s: float = 0.0
    decode_s: float = 0.0
    fused: dict | None = None  # fused-path telemetry (renorm/hatch/fallback)
    routing: dict | None = None  # hybrid per-chunk routing telemetry
    wall_s: float = 0.0        # run_calling's wall (host clock)
    # the phased second pass's own stats (caller/driver.run_second_pass),
    # with its phase+haplotag seconds in phase_s and, where that step ran,
    # its spans' seconds and counters in phase; None without that pass
    phased: "CallStats | None" = None
    phase_s: float = 0.0
    phase: dict | None = None


class _HostCopy:
    """A device result on its way to host memory: a non-blocking copy into
    pinned memory with an event recorded behind it (CUDA), or the tensor
    itself (CPU). numpy() waits for the copy."""

    def __init__(self, out):
        self.event = None
        if out.is_cuda:
            self.host = torch.empty(out.shape, dtype=out.dtype,
                                    pin_memory=True)
            self.host.copy_(out, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = out

    def numpy(self):
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def dispatch_tensor_records(records, forward, params, cfg: PileupConfig,
                            call_cfg: CallConfig,
                            stats: CallStats | None = None):
    """Enqueue inference for a chunk's TensorRecords without blocking.

    Returns an opaque pending handle for collect_rows. Every batch is
    dispatched before any is materialized: the device results start their
    copies to pinned host memory behind CUDA events, so the caller can run
    another chunk's decode while the device works."""
    if not records:
        return None
    is_wire = getattr(forward, "wire", False)
    if is_wire:
        X, codes = batch_wire(records, cfg)
    else:
        X = batch_tensors(records, cfg)
    n = len(X)
    batch = cfg.batch_size
    pending = []
    with spans.span("batch.launch") as launch:
        for lo in range(0, n, batch):
            hi = min(lo + batch, n)
            chunk = X[lo:hi]
            if hi - lo < batch:
                # pad the final flush to the smallest power-of-two bucket
                # that fits (not the full batch shape): padding bytes cross
                # the host->device link too
                bucket = batch
                while bucket // 2 >= hi - lo and bucket // 2 >= 64:
                    bucket //= 2
                pad = np.zeros((bucket - (hi - lo),) + X.shape[1:],
                               X.dtype)
                chunk = np.concatenate([chunk, pad])
            if is_wire:
                ccodes = codes[lo:hi]
                if len(ccodes) < len(chunk):
                    ccodes = np.concatenate([
                        ccodes, np.zeros((len(chunk) - len(ccodes),
                                          codes.shape[1]), codes.dtype)])
                pending.append((lo, hi, _HostCopy(forward(params, chunk,
                                                          ccodes))))
            else:
                pending.append((lo, hi, _HostCopy(forward(params, chunk))))
    if stats is not None:
        stats.infer_s += launch.seconds
    return records, pending, n


def collect_rows(handle, call_cfg: CallConfig,
                 stats: CallStats | None = None):
    """Materialize a dispatched chunk's probabilities and decode VCF rows."""
    if handle is None:
        return []
    records, pending, n = handle
    stats = stats if stats is not None else CallStats()
    n_probs = 24 + (66 if call_cfg.add_indel_length else 0)
    probs = np.empty((n, n_probs), np.float32)
    device_mask = None
    with spans.span("batch.sync") as sync:
        for lo, hi, out in pending:
            arr = out.numpy()[:hi - lo]
            if arr.shape[1] == n_probs + 1:  # wire forward: mask as col -1
                if device_mask is None:
                    device_mask = np.empty(n, dtype=bool)
                device_mask[lo:hi] = arr[:, -1] != 0.0
                arr = arr[:, :-1]
            probs[lo:hi] = arr
    stats.infer_s += sync.seconds

    with spans.span("batch.decode") as decode:
        refseq_list = [r.ref_seq for r in records]
        if device_mask is not None:
            needs_decode = np.ones(n, dtype=bool) if call_cfg.show_ref \
                else device_mask
        else:
            needs_decode = prescreen_mask(probs, refseq_list,
                                          call_cfg.show_ref)
        idx = np.nonzero(needs_decode)[0]
        rows = decode_batch(
            [records[i].ctg_name for i in idx],
            [records[i].position for i in idx],
            [refseq_list[i] for i in idx],
            [records[i].alt_data for i in idx],
            probs[idx], call_cfg)
    stats.decode_s += decode.seconds
    stats.candidates += n
    stats.decoded += len(idx)
    stats.rows += len(rows)
    return rows


def call_tensor_records(records, forward, params, cfg: PileupConfig,
                        call_cfg: CallConfig, stats: CallStats | None = None):
    """Run inference + decode over TensorRecords; returns VCF row strings."""
    handle = dispatch_tensor_records(records, forward, params, cfg, call_cfg,
                                     stats)
    return collect_rows(handle, call_cfg, stats)


def _write_gvcf(output_path, sorted_vcf_path, gvcf_rows_by_contig, fasta,
                ref_path, sample_name):
    """Merge called variants with non-variant blocks into output.g.vcf."""
    from clair3_rna_torch.gvcf import GVCF_EXTRA_HEADER, merge_gvcf_rows
    from clair3_rna_torch.io.vcf import vcf_header
    from clair3_rna_torch.postprocess.sort_vcf import contig_sort_order

    variant_by_contig = {}
    with open(sorted_vcf_path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            variant_by_contig.setdefault(line.split("\t", 1)[0], []).append(
                line.rstrip("\n"))

    gvcf_path = output_path[:-4] + ".g.vcf" if output_path.endswith(".vcf") \
        else output_path + ".g.vcf"
    header = vcf_header(ref_path, sample_name=sample_name)
    header_lines = header.rstrip("\n").split("\n")
    header_lines = header_lines[:-1] + GVCF_EXTRA_HEADER.split("\n") + header_lines[-1:]
    with open(gvcf_path, "w") as out:
        out.write("\n".join(header_lines) + "\n")
        for contig in contig_sort_order(list(gvcf_rows_by_contig)):
            merged = merge_gvcf_rows(
                variant_by_contig.get(contig, []),
                gvcf_rows_by_contig[contig],
                lambda ctg, pos1: fasta.fetch(ctg, pos1 - 1, pos1) or "N")
            out.write("\n".join(merged) + ("\n" if merged else ""))
    return gvcf_path


def _profiler(device):
    """torch.profiler over every thread of the process: without
    profile_all_threads it records the operators and ranges of the calling
    thread only, and none of the prefetch threads' chunk.* spans."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts, experimental_config=(
        _ExperimentalConfig(profile_all_threads=True)))


def _profiled(run):
    """CLAIR3_RNA_TORCH_PROFILE=<dir>: the whole run under _profiler, its
    Chrome trace written to <dir>/trace.json (also after a failure)."""
    @functools.wraps(run)
    def profiled_run(*args, **kwargs):
        profile_dir = os.environ.get("CLAIR3_RNA_TORCH_PROFILE")
        if not profile_dir:
            return run(*args, **kwargs)
        params = kwargs.get("params")
        if params is not None:
            device = params.device
        else:
            from clair3_rna_torch import resolve_device
            device = resolve_device(kwargs.get("device"))
        profiler = _profiler(device)
        try:
            with profiler:
                return run(*args, **kwargs)
        finally:
            os.makedirs(profile_dir, exist_ok=True)
            profiler.export_chrome_trace(
                os.path.join(profile_dir, "trace.json"))
    return profiled_run


JOBLOG_COLUMNS = (
    "contig", "start", "end", "candidates", "build_seconds", "route",
    "worker", "starttime", "donetime", "wait_s", "extract_s", "stage_s",
    "h2d_s", "launch_s", "sync_s", "escape_s", "decode_s", "staged_rows",
    "k1_bytes", "budget", "retries", "net_slabs", "net_graph_slabs")
# the fused chunk pass's spans, in joblog order (ops/fused_pileup.py)
FUSED_STAGES = ("extract", "stage", "h2d", "launch", "sync", "escape",
                "decode")


def _epoch(ns):
    """Unix-epoch nanoseconds -> seconds with 6 decimals, exact."""
    return f"{ns // 1_000_000_000}.{ns // 1000 % 1_000_000:06d}"


def joblog_line(task, candidates, rec, route, wait_s, done_ns):
    """One chunk's joblog row (JOBLOG_COLUMNS) from its span record."""
    c = rec.counters
    return "\t".join([
        task.ctg_name, str(task.start), str(task.end), str(candidates),
        f"{rec.seconds('chunk'):.4f}", route, rec.thread.rsplit("_", 1)[-1],
        _epoch(rec.start_epoch_ns), _epoch(done_ns), f"{wait_s:.6f}",
        *(f"{rec.seconds('chunk.' + k):.6f}" for k in FUSED_STAGES),
        *(str(c.get(k, "")) for k in ("staged_rows", "k1_bytes", "budget")),
        *(str(c.get(k, 0)) for k in ("retries", "net_slabs",
                                     "net_graph_slabs"))]) + "\n"


@_profiled
def run_calling(bam_path: str, ref_path: str, output_path: str, *,
                cfg: PileupConfig | None = None, call_cfg: CallConfig | None = None,
                params=None, forward=None, contigs=None, chunk_size=None,
                rediportal_path=None, output_no_tagging_path=None,
                sample_name=None, cmd_line=None, compress=True,
                known_vcf_positions=None, bed_regions=None, progress=True,
                manifest_dir=None, resume=False, tasks=None, bam=None,
                joblog=None, pileup_backend=None, device=None):
    """Full pileup calling: plan chunks, build tensors, infer, decode, merge.

    params/forward default to a fresh random-init network on `device`
    ("cuda" unless "cpu" is asked for; useful only for testing -- pass
    trained weights for real calling). Given params (a PileupNet), the run
    uses their device.

    manifest_dir enables CHUNK-granular checkpointing: each chunk's decoded
    rows append to {ctg}.chunks.jsonl as soon as every one of its
    candidates has drained from the inference queue (one JSON line per
    chunk, crash-tolerant: a partial trailing line from a kill is ignored
    on restore), and a whole-contig {ctg}.done.json supersedes the line
    file when the contig completes. With resume=True a re-run restores
    finished contigs AND finished chunks of partial contigs, redoing only
    unfinished chunks -- the recovery unit of the reference's per-chunk
    pileup_{ctg}_{chunk}.vcf files + --skip_steps
    (reference src/sort_vcf.py:218-253, run_clair3_rna:855-867).

    joblog writes a per-chunk TSV -- the in-process analogue of the
    reference's GNU `parallel --joblog` per-chunk accounting
    (run_clair3_rna:682,733) -- with the columns of JOBLOG_COLUMNS:
    contig, start, end, candidates, build_seconds (the chunk's whole build
    on its prefetch thread), route (fused, host, or fallback: fused tried,
    host built), worker (prefetch thread 0 or 1), starttime and donetime
    (Unix-epoch seconds, the profiler trace's clock: the build's start,
    and when the main thread had taken the chunk's rows), wait_s (the
    main thread blocked on the chunk's build), the fused pass's spans
    extract_s, stage_s, h2d_s, launch_s, sync_s, escape_s and decode_s
    (0 on host chunks), staged_rows (tilelet rows staged), k1_bytes (what
    the tilelet kernel's launch moves, ops/tilelet.kernel_bytes), budget
    (the fused candidate budget), retries (overflow reruns), net_slabs and
    net_graph_slabs (the network slabs the chunk's build ran, and those of
    them replayed from a CUDA graph, models/network.py; 0 on host chunks,
    whose batches run on the main thread); staged_rows, k1_bytes and
    budget are empty where the chunk staged or ran nothing of theirs (host
    chunks, the events wire).
    Setting CLAIR3_RNA_TORCH_PROFILE=<dir> additionally captures a
    torch.profiler trace of the whole run (<dir>/trace.json, Chrome trace
    format) over every thread: the spans (caller/spans.py) as
    record_function ranges -- call.head and call.tail on the main thread,
    chunk.* on the prefetch threads -- the operators and, on a card, the
    device activity.
    """
    head, tail = spans.span("call.head").start(), spans.span("call.tail")
    try:
        t_run = time.perf_counter()
        cfg = cfg or PileupConfig()
        call_cfg = call_cfg or CallConfig()
        if params is None:
            from clair3_rna_torch import resolve_device
            from clair3_rna_torch.models.network import init_params
            params = init_params(0, phased=cfg.phased,
                                 device=resolve_device(device))
        if forward is None:
            from clair3_rna_torch.models.network import make_wire_forward_fn
            _, forward = make_wire_forward_fn(
                add_indel_length=call_cfg.add_indel_length)

        from clair3_rna_torch.pileup.chunk import open_bam
        fasta = FastaFile(ref_path)
        if bam is None:  # callers making several passes should open once
            bam = open_bam(bam_path)
        if tasks is None:
            tasks = plan_chunks(fasta, contigs=contigs,
                                chunk_size=chunk_size or config.CHUNK_SIZE)
        stats = CallStats()
        rows_by_contig: dict = {}
        gvcf_enabled = bool(call_cfg.gvcf)
        # non-variant blocks keyed per chunk so chunk-granular manifests and
        # out-of-order restores keep genomic order (flattened by gvcf_rows_for)
        gvcf_by_chunk: dict = {}

        def gvcf_rows_for(ctg):
            rows = []
            for key in sorted((k for k in gvcf_by_chunk if k[0] == ctg),
                              key=lambda k: k[1]):
                rows.extend(gvcf_by_chunk[key])
            return rows

        # fused device route (ops/fused_pileup): the whole chunk -- tilelet
        # expansion, candidate mask, window gather, network, prescreen -- runs
        # as one device pass over staged packed-read tensors. Renorm-depth
        # candidates take the host float64 scale (_renorm_records); isolated
        # splice-trigger candidates rebuild host-side (_hatch_records); only
        # overflow / clustered-trigger chunks fall back wholesale. Selected by
        # --pileup_backend host|fused|hybrid (both routes are row-identical, so
        # hybrid's per-chunk mix merges exactly). GVCF runs (which need every
        # covered site's depth host-side) and --debug stay on the host route.
        from clair3_rna_torch.caller.backend import (cached_link_bandwidth,
                                                     resolve_backend)
        backend = resolve_backend(pileup_backend)
        fused_caller = None
        route_policy = None
        if backend in ("fused", "hybrid") and not call_cfg.gvcf \
                and not call_cfg.debug:
            from clair3_rna_torch.ops.fused_pileup import FusedChunkCaller
            fused_caller = FusedChunkCaller(
                params, cfg, call_cfg,
                known_only=known_vcf_positions is not None,
                with_masks=bed_regions is not None)
            if backend == "hybrid":
                route_policy = _get_route_policy(
                    bam_path, cached_link_bandwidth(params.device),
                    getattr(bam, "ref_index", {}))
                routing0 = route_policy.counters()
                if not route_policy.usable:
                    logger.info("[INFO] hybrid backend: no BAI index -> all "
                                "chunks on the host route")

        # build prefetch: the host builds chunk i+1 (C++ + numpy, GIL-releasing)
        # while the device runs inference on chunk i -- the in-process analogue of
        # the reference's tensor-builder/caller process pipe overlap
        # (clair3_rna/call_var_bam.py:288-295)
        from concurrent.futures import ThreadPoolExecutor

        def fused_one(task):
            """Fused-path chunk; None -> host fallback.

            Data (and window eligibility) span the +-33 halo, but candidates are
            emitted over the chunk core [task.start, task.end) only: cores tile
            the contig exactly, so no candidate is emitted twice. The host route
            also emits halo candidates whose window lies in its data (identical
            rows the merge dedups away), except under head/tail, where a halo
            window is cut at the data edge and the host route emits over the
            core alone (pileup/chunk.build_chunk_tensors)."""
            from clair3_rna_torch.pileup.chunk import (extract_region_events,
                                                       ref_codes_from)
            from clair3_rna_torch.pileup.packed import extract_region_packed
            with spans.span("chunk.extract"):
                window = config.NO_OF_POSITIONS
                contig_len = fasta.contig_length(task.ctg_name)
                row_lo = max(0, task.start - window)
                row_hi = min(contig_len, task.end + window)
                ref_lo = max(0, task.start - config.EXPAND_REFERENCE_REGION)
                ref_hi = min(contig_len,
                             task.end + config.EXPAND_REFERENCE_REGION)
                ref_seq = fasta.fetch(task.ctg_name, ref_lo, ref_hi)
                codes = ref_codes_from(
                    ref_seq[row_lo - ref_lo: row_hi - ref_lo])
                if fused_caller.mode == "packed":
                    data = extract_region_packed(bam, task.ctg_name, row_lo,
                                                 row_hi, cfg)
                    if route_policy is not None:
                        route_policy.observe(task.ctg_name, task.start, task.end,
                                             data.n_base)
                else:
                    data = extract_region_events(bam, task.ctg_name, row_lo,
                                                 row_hi, cfg)
                cover_allow = cand_allow = None
                if bed_regions is not None:
                    from clair3_rna_torch.pileup.chunk import _extend_regions
                    extended = _extend_regions(bed_regions, task.ctg_name,
                                               window)
                    cover_allow = extended.mask_for_range(task.ctg_name, row_lo,
                                                          row_hi)
                    mdl = np.zeros(row_hi - row_lo, np.int64)
                    if len(data.del_pos):
                        np.maximum.at(mdl,
                                      data.del_pos.astype(np.int64) - row_lo,
                                      data.del_len.astype(np.int64))
                    positions = np.arange(row_lo, row_hi, dtype=np.int64)
                    cand_allow = bed_regions.overlaps(task.ctg_name, positions,
                                                      positions + mdl + 2)
                if known_vcf_positions is not None:
                    kp = np.asarray(known_vcf_positions.get(task.ctg_name, []),
                                    dtype=np.int64) - row_lo
                    kp = kp[(kp >= 0) & (kp < row_hi - row_lo)]
                    cand_allow = np.zeros(row_hi - row_lo, np.int8)
                    cand_allow[kp] = 1
                host_ctx = {
                    "bam": bam, "fasta": fasta, "forward": forward,
                    "known_positions": known_vcf_positions.get(task.ctg_name)
                    if known_vcf_positions else None,
                    "bed_regions": bed_regions,
                }
            return fused_caller.call_chunk(data, codes, task.ctg_name, ref_seq,
                                           ref_lo, task.start, task.end,
                                           cover_allow=cover_allow,
                                           cand_allow=cand_allow,
                                           host_ctx=host_ctx)

        def build_one(task):
            """One chunk's build on a prefetch thread -> (built, route, its
            span record); the span "chunk" is the whole build."""
            with spans.Chunk() as rec, spans.span("chunk") as whole:
                built, route = build_routed(task, whole)
            return built, route, rec

        def build_routed(task, whole):
            tried_fused = False
            if fused_caller is not None and (
                    route_policy is None
                    or route_policy.route(task.ctg_name, task.start,
                                          task.end) == "fused"):
                tried_fused = True
                one_offs = fused_caller.one_off_count
                fused_out = fused_one(task)
                if fused_out is not None:
                    if route_policy is not None:
                        # a chunk that paid a one-off (the caller's first pass
                        # at a budget, a CUDA library build) records no wall
                        route_policy.observe_wall(
                            "fused", task.ctg_name, task.start, task.end,
                            whole.elapsed(),
                            compiled=fused_caller.one_off_count > one_offs)
                    return ("rows",) + fused_out, "fused"
                if route_policy is not None:
                    route_policy.observe_failure(task.ctg_name, task.start,
                                                 task.end)
            with spans.span("chunk.build"):
                out = build_chunk_tensors(
                    bam, fasta, task, cfg,
                    known_positions=known_vcf_positions.get(task.ctg_name)
                    if known_vcf_positions else None,
                    bed_regions=bed_regions, return_features=True,
                    device=params.device)
            if route_policy is not None:
                # calibrate the byte->base ratio from host-routed chunks too
                # (depth = ACGT + star entries, a close proxy for aligned bases)
                route_policy.observe(task.ctg_name, task.start, task.end,
                                     int(out[1].depth.sum()))
                if not tried_fused:
                    # a chunk that fell back from fused has a mixed wall: only
                    # pure host chunks record host walls
                    route_policy.observe_wall("host", task.ctg_name,
                                              task.start, task.end,
                                              whole.elapsed())
            return ("records", out), "fallback" if tried_fused else "host"

        # two workers keep two chunk builds in flight: the C++ tile builder and
        # most numpy stages release the GIL, so a second build overlaps the main
        # thread's decode work (and note build_s then counts overlapped
        # thread-wall time, so it can exceed its wall-clock contribution)
        prefetcher = ThreadPoolExecutor(max_workers=2,
                                        thread_name_prefix="chunk")
        # cross-chunk batch accumulation: candidates stream into full
        # batch_size-sized device batches regardless of chunk boundaries (the
        # reference also streams a fixed batch across its whole tensor pipe,
        # clair3_rna/utils.py:51-61), so no batch is padded except the final
        # flush and per-call dispatch latency amortizes. Up to two device
        # batches stay in flight while the host builds and decodes.
        from collections import deque
        queue_records: deque = deque()
        in_flight: deque = deque()

        def drain_one():
            rows = collect_rows(in_flight.popleft(), call_cfg, stats)
            for row in rows:
                ctg = row.split("\t", 1)[0]
                rows_by_contig.setdefault(ctg, []).append(row)
                if manifest_dir:
                    bucket_row(ctg, row)

        def pump(force=False):
            while len(queue_records) >= cfg.batch_size:
                group = [queue_records.popleft() for _ in range(cfg.batch_size)]
                in_flight.append(dispatch_tensor_records(
                    group, forward, params, cfg, call_cfg, stats))
                while len(in_flight) > 2:
                    drain_one()
            if force:
                if queue_records:
                    group = list(queue_records)
                    queue_records.clear()
                    in_flight.append(dispatch_tensor_records(
                        group, forward, params, cfg, call_cfg, stats))
                while in_flight:
                    drain_one()

        import hashlib
        import json

        # manifests are only resumable under the SAME calling configuration: a
        # different model / decode config / candidate source would make restored
        # rows silently wrong (advisor r04). The signature covers everything
        # that changes row content; chunk GEOMETRY is validated separately
        # against the planned task list (so a changed --chunk_size discards
        # stale ranges instead of restoring overlapping rows).
        cfg_sig = hashlib.sha1(repr((
            repr(cfg), repr(call_cfg),
            sorted(known_vcf_positions) if known_vcf_positions else None,
            bed_regions is not None,
        )).encode()).hexdigest()[:12]

        def manifest_path(ctg):
            return os.path.join(manifest_dir, f"{ctg}.done.json")

        def chunks_path(ctg):
            return os.path.join(manifest_dir, f"{ctg}.chunks.jsonl")

        def load_manifest(ctg):
            try:
                with open(manifest_path(ctg)) as f:
                    payload = json.load(f)
            except Exception:
                return None
            if payload.get("config") != cfg_sig:
                return None  # written under a different run config: redo
            return payload

        def save_manifest(ctg):
            payload = {"rows": rows_by_contig.get(ctg, []), "config": cfg_sig}
            if gvcf_enabled:
                payload["gvcf"] = gvcf_rows_for(ctg)
            tmp = manifest_path(ctg) + ".tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, manifest_path(ctg))  # idempotent atomic publish
            pending_manifest.pop(ctg, None)
            try:  # the contig-level manifest supersedes the per-chunk lines
                os.remove(chunks_path(ctg))
            except OSError:
                pass

        def load_chunk_manifest(ctg, planned):
            """{(start, end): payload} from the per-chunk line file; tolerates a
            torn trailing line (crash mid-append) and duplicate lines from
            repeated crash/resume cycles (first complete line wins). Entries
            whose geometry is not in `planned` or whose config signature
            differs are discarded (stale --chunk_size / flags, advisor r04)."""
            entries = {}
            try:
                with open(chunks_path(ctg)) as f:
                    for line in f:
                        if not line.endswith("\n"):
                            break  # torn tail from a kill mid-write
                        try:
                            rec = json.loads(line)
                        except ValueError:
                            break
                        if rec.get("config") != cfg_sig:
                            continue
                        if (ctg, rec["start"], rec["end"]) not in planned:
                            continue
                        entries.setdefault((rec["start"], rec["end"]), rec)
            except OSError:
                pass
            return entries

        def append_chunk_manifest(ctg, start, end, rows, gvcf_rows):
            rec = {"start": start, "end": end, "rows": rows, "config": cfg_sig}
            if gvcf_enabled:
                rec["gvcf"] = gvcf_rows or []
            with open(chunks_path(ctg), "a") as f:
                f.write(json.dumps(rec) + "\n")

        # chunk-manifest bookkeeping: a chunk's line is appended once every one
        # of its candidates has drained from the cross-chunk inference queue.
        # Built chunks enter pending_manifest in build (= genomic) order; the
        # drain frontier is the smallest still-undecoded candidate position per
        # contig, so a chunk is complete exactly when the frontier passes its
        # end. Rows are attributed to chunks at APPEND time (bisect into the
        # planned chunk bounds) instead of re-scanning the contig's whole
        # accumulated row list per flush, which grew O(chunks x total_rows) on
        # large contigs (advisor r04).
        pending_manifest: dict = {}  # ctg -> deque[(start, end)]
        chunk_rows: dict = {}        # (ctg, start) -> [row, ...]
        bounds_by_ctg: dict = {}     # ctg -> sorted [(start, end), ...]

        def note_built(task):
            if manifest_dir:
                pending_manifest.setdefault(task.ctg_name, deque()).append(
                    (task.start, task.end))

        def bucket_row(ctg, row):
            """Attribute a freshly decoded row to its planned chunk (halo
            duplicates land wherever their position falls, exactly as the old
            position re-scan attributed them)."""
            from bisect import bisect_right
            b = bounds_by_ctg.get(ctg)
            if not b:
                return
            pos0 = int(row.split("\t", 2)[1]) - 1
            i = bisect_right(b, (pos0, 1 << 62)) - 1
            if i >= 0 and b[i][0] <= pos0 < b[i][1]:
                chunk_rows.setdefault((ctg, b[i][0]), []).append(row)

        def flush_chunk_manifests(final=False):
            if not manifest_dir:
                return
            frontier: dict = {}
            if not final:
                pending_records = list(queue_records)
                for handle in in_flight:
                    if handle is not None:
                        pending_records.extend(handle[0])
                for rec in pending_records:
                    p0 = rec.position - 1
                    if p0 < frontier.get(rec.ctg_name, 1 << 62):
                        frontier[rec.ctg_name] = p0
            for ctg, dq in pending_manifest.items():
                fr = frontier.get(ctg)
                while dq and (fr is None or dq[0][1] <= fr):
                    s, e = dq.popleft()
                    append_chunk_manifest(ctg, s, e,
                                          chunk_rows.pop((ctg, s), []),
                                          gvcf_by_chunk.get((ctg, s)))

        if manifest_dir:
            os.makedirs(manifest_dir, exist_ok=True)
            if resume:
                skip_ctgs = set()
                for ctg in {t.ctg_name for t in tasks}:
                    payload = load_manifest(ctg)
                    if payload is not None and (
                            not gvcf_enabled or "gvcf" in payload):
                        rows_by_contig[ctg] = payload["rows"]
                        if gvcf_enabled:
                            gvcf_by_chunk[(ctg, -1)] = payload["gvcf"]
                        stats.rows += len(payload["rows"])
                        skip_ctgs.add(ctg)
                        if progress:
                            logger.info("[INFO] resume: contig %s restored from "
                                        "manifest (%d rows)", ctg,
                                        len(payload["rows"]))
                tasks = [t for t in tasks if t.ctg_name not in skip_ctgs]
                # chunk-granular restore for contigs that did not finish;
                # entries are validated against the PLANNED geometry (a changed
                # --chunk_size or region set must not restore stale ranges)
                planned = {(t.ctg_name, t.start, t.end) for t in tasks}
                done_chunks = set()
                for ctg in sorted({t.ctg_name for t in tasks}):
                    entries = load_chunk_manifest(ctg, planned)
                    if gvcf_enabled:
                        entries = {k: rec for k, rec in entries.items()
                                   if "gvcf" in rec}
                    if not entries:
                        continue
                    for (s, e), rec in sorted(entries.items()):
                        rows_by_contig.setdefault(ctg, []).extend(rec["rows"])
                        if gvcf_enabled:
                            gvcf_by_chunk[(ctg, s)] = rec.get("gvcf", [])
                        stats.rows += len(rec["rows"])
                        done_chunks.add((ctg, s, e))
                    # rewrite compacted (dedup + torn tail dropped), atomically
                    tmp = chunks_path(ctg) + ".tmp"
                    with open(tmp, "w") as f:
                        for (_s, _e), rec in sorted(entries.items()):
                            f.write(json.dumps(rec) + "\n")
                    os.replace(tmp, chunks_path(ctg))
                    if progress:
                        logger.info("[INFO] resume: contig %s restored %d "
                                    "finished chunk(s) from the chunk manifest",
                                    ctg, len(entries))
                tasks = [t for t in tasks
                         if (t.ctg_name, t.start, t.end) not in done_chunks]
            else:
                # fresh run: stale chunk lines AND contig manifests from an
                # earlier attempt must not survive into this run's files (a
                # stale {ctg}.done.json would otherwise be silently preferred
                # over this run's chunk lines on a later resume, advisor r04)
                for ctg in {t.ctg_name for t in tasks}:
                    for stale in (chunks_path(ctg), manifest_path(ctg)):
                        try:
                            os.remove(stale)
                        except OSError:
                            pass
        if manifest_dir:
            for t in tasks:
                bounds_by_ctg.setdefault(t.ctg_name, []).append(
                    (t.start, t.end))
            for b in bounds_by_ctg.values():
                b.sort()

        joblog_f = None
        if joblog:
            joblog_f = open(joblog, "w")
            joblog_f.write("\t".join(JOBLOG_COLUMNS) + "\n")

        def taken(i, task, n, route, rec, wait):
            """The main thread has taken chunk i's rows: its joblog row; after
            the last chunk the run's tail begins."""
            if joblog_f:
                joblog_f.write(joblog_line(task, n, rec, route, wait.seconds,
                                           time.time_ns()))
            if i + 1 == len(tasks):
                tail.start()

        try:
            head.stop()
            # a deque of at most 2 pending futures: a completed Future pins its
            # result (records + the chunk's dense TileFeatures, ~20 MB), so
            # holding one per task leaks the whole genome's worth of chunk
            # working sets (measured: 21 GB RSS over 1001 chunks) -- each future
            # must be dropped as soon as its result is consumed
            pending_builds = deque(
                prefetcher.submit(build_one, task) for task in tasks[:2])
            for i, task in enumerate(tasks):
                if i + 2 < len(tasks):
                    pending_builds.append(
                        prefetcher.submit(build_one, tasks[i + 2]))
                # a wait is no work: counted, but no profiler range, which
                # would cover every idle gap of the device
                with spans.span("pipeline.wait", profile=False) as wait:
                    built, route, rec = pending_builds.popleft().result()
                stats.build_s += rec.seconds("chunk")
                if built[0] == "rows":  # fused path: decoded rows directly
                    _, fused_rows, n_fused = built
                    stats.candidates += n_fused
                    stats.rows += len(fused_rows)
                    for row in fused_rows:
                        ctg = row.split("\t", 1)[0]
                        rows_by_contig.setdefault(ctg, []).append(row)
                        if manifest_dir:
                            bucket_row(ctg, row)
                    taken(i, task, n_fused, route, rec, wait)
                    note_built(task)
                    contig_done = (i + 1 == len(tasks)
                                   or tasks[i + 1].ctg_name != task.ctg_name)
                    pump(force=manifest_dir is not None and contig_done)
                    if manifest_dir and contig_done:
                        save_manifest(task.ctg_name)
                    flush_chunk_manifests()
                    if progress:
                        logger.info("chunk %s:%d-%d: %d candidates (fused)",
                                    task.ctg_name, task.start, task.end, n_fused)
                    continue
                records, feat, ref_seq, ref_lo = built[1]
                if gvcf_enabled:
                    from clair3_rna_torch.gvcf import NonVariantAccumulator
                    from clair3_rna_torch.pileup.chunk import gvcf_site_arrays
                    acc = NonVariantAccumulator(
                        p_err=call_cfg.gvcf_p_err,
                        gq_bin_size=call_cfg.gvcf_gq_bin_size,
                        bp_resolution=call_cfg.gvcf_bp_resolution)
                    sites = gvcf_site_arrays(feat, task, ref_seq, ref_lo)
                    if sites is None:
                        acc.push_empty_region(task.ctg_name, task.start + 1,
                                              task.end)
                    else:
                        positions, refs, n_total, n_ref = sites
                        acc.push_array(task.ctg_name, positions, refs, n_total,
                                       n_ref)
                    gvcf_by_chunk[(task.ctg_name, task.start)] = acc.finish()
                queue_records.extend(records)
                taken(i, task, len(records), route, rec, wait)
                note_built(task)
                contig_done = (i + 1 == len(tasks)
                               or tasks[i + 1].ctg_name != task.ctg_name)
                pump(force=manifest_dir is not None and contig_done)
                if manifest_dir and contig_done:
                    save_manifest(task.ctg_name)
                flush_chunk_manifests()
                if progress:
                    logger.info("chunk %s:%d-%d: %d candidates",
                                task.ctg_name, task.start, task.end, len(records))
            if not tasks:
                tail.start()
            pump(force=True)
        finally:
            # pending builds are cancelled and running ones waited for, so no
            # thread of a finished or failed run touches the BAM handle or the
            # device after run_calling returns or raises
            prefetcher.shutdown(wait=True, cancel_futures=True)
            if joblog_f:
                joblog_f.close()

        rediportal = load_rediportal(rediportal_path, contigs=list(rows_by_contig))
        outputs, n_rows, n_tagged = sort_rows(
            rows_by_contig, output_path,
            show_ref=call_cfg.show_ref,
            qual_cutoff=cfg.effective_qual_cutoff,
            rediportal=rediportal,
            output_no_tagging_fn=output_no_tagging_path if rediportal else None,
            reference_file_path=ref_path,
            sample_name=sample_name or cfg.sample_name,
            cmd_line=cmd_line, compress=False)

        if fused_caller is not None:
            stats.fused = fused_caller.counters()
        if route_policy is not None:
            stats.routing = route_policy.counters()
            for key in ("fused_chunks", "host_chunks", "explore_chunks",
                        "fused_failures"):
                stats.routing[key] -= routing0[key]
        if gvcf_enabled:
            gvcf_rows_by_contig = {ctg: gvcf_rows_for(ctg)
                                   for ctg in {k[0] for k in gvcf_by_chunk}}
            outputs.append(_write_gvcf(output_path, outputs[0], gvcf_rows_by_contig,
                                       fasta, ref_path,
                                       sample_name or cfg.sample_name))
        if compress:
            from clair3_rna_torch.io.vcf import compress_index_vcf
            outputs = [compress_index_vcf(p) for p in outputs]
        if progress:
            logger.info(
                "calling done: %d candidates, %d decoded, %d rows (%d tagged); "
                "build %.2fs infer %.2fs decode %.2fs",
                stats.candidates, stats.decoded, n_rows, n_tagged,
                stats.build_s, stats.infer_s, stats.decode_s)
            if stats.fused is not None:
                logger.info(
                    "fused path: %d renormalized candidates over %d chunks "
                    "(device-window fetch), %d splice-hatched candidates over "
                    "%d chunks, %d budget retries, %d whole-chunk host "
                    "fallbacks",
                    stats.fused["renorm_candidates"],
                    stats.fused["renorm_chunks"],
                    stats.fused["hatch_candidates"], stats.fused["hatch_chunks"],
                    stats.fused["overflow_retries"],
                    stats.fused["fallback_chunks"])
            if stats.routing is not None:
                logger.info(
                    "hybrid routing: %d chunks fused, %d host, %d fused "
                    "failures (calibrated %.2f bases/compressed-byte, link "
                    "%.3g B/s)",
                    stats.routing["fused_chunks"], stats.routing["host_chunks"],
                    stats.routing["fused_failures"],
                    stats.routing["bases_per_cbyte"], stats.routing["link_bps"])
        tail.stop()
        stats.wall_s = time.perf_counter() - t_run
        return outputs, stats
    finally:
        # stop() is a no-op on a span already stopped or never started:
        # a run that raises leaves no profiler range open
        head.stop()
        tail.stop()
