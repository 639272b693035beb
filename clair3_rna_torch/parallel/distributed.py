"""Multi-process calling: torch.distributed + contig-shard data parallelism.

The reference fans chunks out as GNU-parallel OS processes on one machine
(run_clair3_rna:681-707) and has no cross-host story. As in the JAX
package (SURVEY §2.3), the *genome coordinate axis* shards across processes:

  - every process calls `initialize()` (a gloo process group), then owns
    the deterministic subset of (contig, chunk) work items returned by
    `shard_tasks_lpt` (or round-robin `shard_tasks`);
  - each process runs the normal in-process streaming pipeline over its
    shard on its own device (or a dp x tp mesh of its local cards,
    parallel/mesh.py), writing per-shard row manifests (idempotent atomic
    files -- the same mechanism the single-process --resume uses);
  - `merge_shards` (one process, once every shard is done) reads every
    shard's manifests and emits one contig-major, position-sorted VCF,
    identical regardless of shard count.

Weights replicate (the pileup net is ~2M params); nothing about the model
needs cross-process collectives, so no tensor crosses processes and the
process group is gloo: several shard processes may share one card, which
NCCL refuses. A collective on card tensors would take the backend
"cpu:gloo,cuda:nccl". The only cross-process traffic is the final row
merge, through files.
"""

import json
import logging
import os

logger = logging.getLogger(__name__)


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """torch.distributed.init_process_group over tcp://coordinator_address
    (host:port) with gloo; no-op for single-process runs. Returns
    (world size, rank)."""
    if num_processes is None or num_processes <= 1:
        return 1, 0
    import torch.distributed as dist
    dist.init_process_group(backend="gloo",
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return dist.get_world_size(), dist.get_rank()


def shard_tasks(tasks, n_shards, shard_id):
    """Deterministic interleaved partition of (contig, chunk) work items.

    Round-robin over the task list keeps every shard's work within one chunk
    of even regardless of contig length skew (a genome is a few long contigs
    plus many short ones). Fallback policy when no per-chunk cost estimates
    exist; see shard_tasks_lpt."""
    if not (0 <= shard_id < n_shards):
        raise ValueError(f"shard_id {shard_id} outside [0, {n_shards})")
    return [t for i, t in enumerate(tasks) if i % n_shards == shard_id]


# per-chunk fixed cost in compressed-byte equivalents: chunk wall =
# fixed (image finalize, seeks, dispatch) + bytes-proportional work; on the
# measured host the fixed ~0.06 s equals the decode+build of ~1.5 MB of
# compressed records (caller/backend.py cost-model constants)
CHUNK_FIXED_COST_CBYTES = float(os.environ.get(
    "CLAIR3_RNA_TORCH_CHUNK_FIXED_COST_CBYTES", 1.5e6))


def estimate_chunk_costs(bam_path, tasks):
    """Per-chunk cost estimates from the BAI compressed-byte spans each
    chunk's region covers (io/bai.py; the same R-tree every fetch prunes
    with). Builds the index if missing -- idempotent and exactly what
    open_bam would do anyway, so every shard process computes the SAME
    estimates regardless of start order. Returns None when no index can
    exist (unwritable directory, unsorted BAM)."""
    from clair3_rna_torch.io.bai import (BaiIndex, build_index,
                                         index_path_for)
    from clair3_rna_torch.io.bam import BamReader

    bai_path = index_path_for(bam_path)
    if bai_path is None:
        try:
            build_index(bam_path)
            bai_path = index_path_for(bam_path)
        except Exception:
            return None
    if bai_path is None:
        return None
    try:
        bai = BaiIndex.load(bai_path)
        ref_index = BamReader(bam_path, load_index=False).ref_index
    except Exception:
        return None
    costs = []
    for t in tasks:
        rid = ref_index.get(t.ctg_name)
        cb = 0
        if rid is not None:
            for vbeg, vend in bai.query(rid, t.start, t.end):
                cb += max((vend >> 16) - (vbeg >> 16), 0)
        costs.append(CHUNK_FIXED_COST_CBYTES + cb)
    return costs


def shard_tasks_lpt(tasks, n_shards, shard_id, costs):
    """Cost-aware deterministic partition: LPT (longest-processing-time
    first) over the per-chunk cost estimates. Classic greedy bound
    (makespan <= 4/3 OPT); in practice it removes the tail imbalance
    round-robin shows once per-shard chunk counts drop to a few dozen
    (SCALE_RUN measured 80.2% efficiency at 32 shards round-robin).

    Fully deterministic -- ties break on (load, shard_id) then task index --
    so every shard process derives the identical global assignment from the
    same (tasks, costs) without coordination, exactly like shard_tasks."""
    import heapq

    if not (0 <= shard_id < n_shards):
        raise ValueError(f"shard_id {shard_id} outside [0, {n_shards})")
    if len(costs) != len(tasks):
        raise ValueError("costs must align with tasks")
    order = sorted(range(len(tasks)), key=lambda i: (-costs[i], i))
    heap = [(0.0, s) for s in range(n_shards)]
    assign = [0] * len(tasks)
    for i in order:
        load, s = heapq.heappop(heap)
        assign[i] = s
        heapq.heappush(heap, (load + costs[i], s))
    return [t for i, t in enumerate(tasks) if assign[i] == shard_id]


def shard_manifest_dir(base_dir, shard_id):
    return os.path.join(base_dir, f"shard_{shard_id:04d}")


def run_sharded_calling(bam_path, ref_path, work_dir, *, cfg, call_cfg,
                        params, forward, contigs, n_shards, shard_id,
                        chunk_size=None, known_vcf_positions=None,
                        bed_regions=None, progress=False, resume=False,
                        pileup_backend=None, device=None):
    """One shard's worth of calling; rows persist as shard manifests.
    params/forward as run_calling's (None: random weights on `device`).

    Unlike run_calling this writes no merged VCF -- merge_shards does that
    once, after every shard reports complete."""
    from clair3_rna_torch import config as _config
    from clair3_rna_torch.caller.pipeline import run_calling

    manifest_dir = shard_manifest_dir(work_dir, shard_id)
    from clair3_rna_torch.io.fasta import FastaFile
    from clair3_rna_torch.pileup.chunk import plan_chunks
    fasta = FastaFile(ref_path)
    tasks = plan_chunks(fasta, contigs=contigs,
                        chunk_size=chunk_size or _config.CHUNK_SIZE)
    costs = estimate_chunk_costs(bam_path, tasks)
    if costs is not None:
        mine = shard_tasks_lpt(tasks, n_shards, shard_id, costs)
    else:
        mine = shard_tasks(tasks, n_shards, shard_id)
    # each shard runs the normal streaming pipeline over its own task list
    # and keeps its own manifest dir: per-(shard, contig) row files that
    # double as this shard's --resume state and as merge input
    _, stats = run_calling(
        bam_path, ref_path,
        os.path.join(manifest_dir, "_scratch.vcf"),
        cfg=cfg, call_cfg=call_cfg, params=params, forward=forward,
        contigs=contigs, chunk_size=chunk_size,
        known_vcf_positions=known_vcf_positions, bed_regions=bed_regions,
        progress=progress, compress=False, manifest_dir=manifest_dir,
        resume=resume, tasks=mine, pileup_backend=pileup_backend,
        device=device)
    return stats


def run_shards_with_retry(shard_fn, n_shards, max_retries=2):
    """Run shard_fn(shard_id, resume) for every shard with bounded retry.

    The elasticity analogue of the reference's watchdog + step abort
    (clair3_rna/call_var_bam.py:71-85): a failed shard is
    re-run with resume=True -- idempotent via its chunk manifests, so only
    the chunks that had not checkpointed are redone -- up to max_retries
    times before the failure propagates. Returns the per-shard results."""
    results = []
    for shard_id in range(n_shards):
        attempt = 0
        while True:
            try:
                results.append(shard_fn(shard_id, attempt > 0))
                break
            except Exception as exc:
                attempt += 1
                if attempt > max_retries:
                    raise
                logger.warning(
                    "[WARNING] shard %d failed (%s); retry %d/%d with "
                    "resume", shard_id, exc, attempt, max_retries)
    return results


def merge_shards(work_dir, n_shards, output_fn, *, show_ref=False,
                 qual_cutoff=None, rediportal=None, reference_file_path=None,
                 sample_name="SAMPLE", cmd_line=None, compress=True):
    """Host-0 merge: gather every shard's chunk manifests into one sorted VCF.

    Deterministic for any shard count: rows are keyed (contig, position) and
    sorted contig-major exactly like the single-host path."""
    from clair3_rna_torch.postprocess.sort_vcf import sort_rows

    rows_by_contig = {}
    for shard_id in range(n_shards):
        sdir = shard_manifest_dir(work_dir, shard_id)
        if not os.path.isdir(sdir):
            raise FileNotFoundError(f"missing shard manifest dir: {sdir}")
        for fn in sorted(os.listdir(sdir)):
            if not fn.endswith(".done.json"):
                continue
            with open(os.path.join(sdir, fn)) as f:
                for row in json.load(f)["rows"]:
                    rows_by_contig.setdefault(
                        row.split("\t", 1)[0], []).append(row)
    outputs, n_rows, n_tagged = sort_rows(
        rows_by_contig, output_fn, show_ref=show_ref,
        qual_cutoff=qual_cutoff, rediportal=rediportal,
        reference_file_path=reference_file_path, sample_name=sample_name,
        cmd_line=cmd_line, compress=compress)
    return outputs, n_rows, n_tagged
