"""Top-level calling orchestration (the run_clair3_rna equivalent).

Resolves contigs/regions, loads weights, runs the pileup pass on one
device (or a dp x tp mesh of the local cards) and optionally the phasing
pass (phase -> haplotag -> 30-channel re-call), then merges outputs
(run_clair3_rna:668-878 workflow, without shell process plumbing). With
--n_shards/--shard_id a process calls its share of the chunks into shard
manifests for merge_shards (parallel/distributed.py).
"""

import logging
import os

from clair3_rna_torch import config, resolve_device
from clair3_rna_torch.caller.decode import CallConfig
from clair3_rna_torch.caller.pipeline import run_calling
from clair3_rna_torch.io.bam import BamReader
from clair3_rna_torch.io.bed import BedRegions
from clair3_rna_torch.io.fasta import FastaFile
from clair3_rna_torch.io.vcf import VcfReader
from clair3_rna_torch.postprocess.sort_vcf import MAJOR_CONTIGS_ORDER

logger = logging.getLogger(__name__)


def resolve_contigs(bam: BamReader, fasta: FastaFile, ctg_name=None,
                    include_all_ctgs=False, bed_regions=None):
    """Contig intersection logic (run_clair3_rna:314-451): BAM ∩ FASTA,
    restricted to major contigs unless include_all_ctgs, further filtered by
    explicit list / bed."""
    contigs = [c for c in fasta.contigs if c in bam.ref_index]
    if ctg_name:
        wanted = ctg_name.split(",") if isinstance(ctg_name, str) else list(ctg_name)
        contigs = [c for c in contigs if c in set(wanted)]
    elif not include_all_ctgs:
        major = set(MAJOR_CONTIGS_ORDER)
        major_found = [c for c in contigs if c in major]
        if major_found:
            contigs = major_found
    if bed_regions is not None:
        contigs = [c for c in contigs if not bed_regions.is_empty(c)]
    return contigs


def load_model(model_path, add_indel_length=False, phased=False,
               device="cuda", mesh=None):
    """Load (or random-init) weights onto `device`; returns (params,
    forward) with forward the wire forward and params a PileupNet, or with
    a mesh a ShardedNet laid out per parallel.mesh.param_spec, which the
    wire forward's network call (and the fused route's) runs with the batch
    split over the mesh's dp rows -- the in-process analogue of the
    reference's GNU-parallel chunk fan-out (run_clair3_rna:681-707)."""
    from clair3_rna_torch.models.network import (init_params,
                                                 make_wire_forward_fn)
    from clair3_rna_torch.models.params_io import (params_from_numpy,
                                                   resolve_params)
    device = resolve_device(device)
    if model_path:
        params = params_from_numpy(
            resolve_params(model_path, add_indel_length=add_indel_length),
            device=device)
    else:
        logger.warning("[WARNING] no --model_path given: using RANDOM weights "
                       "(testing only, calls will be meaningless)")
        params = init_params(0, add_indel_length=add_indel_length,
                             phased=phased, device=device)
    if mesh is not None:
        from clair3_rna_torch.parallel.mesh import shard_params
        params = shard_params(params, mesh)
    _, forward = make_wire_forward_fn(add_indel_length=add_indel_length)
    return params, forward


def default_mesh(tp=1, device="cuda"):
    """A ('dp','tp') mesh over every CUDA card when `device` is CUDA and
    there is more than one card; None otherwise (single device)."""
    import torch
    if torch.device(device).type != "cuda" or torch.cuda.device_count() <= 1:
        return None
    from clair3_rna_torch.parallel.mesh import make_mesh
    return make_mesh(tp=tp)


def _mesh_for(args, cfg, device):
    """(mesh or None, cfg with batch_size rounded up to a multiple of dp)
    for a calling pass: the default mesh unless --no_device_mesh."""
    mesh = None
    if not getattr(args, "no_device_mesh", False):
        mesh = default_mesh(tp=getattr(args, "tp", 1), device=device)
    if mesh is not None:
        dp = mesh.shape["dp"]
        if cfg.batch_size % dp:
            cfg = cfg.with_(batch_size=((cfg.batch_size // dp) + 1) * dp)
        logger.info("[INFO] device mesh: dp=%d tp=%d", dp, mesh.shape["tp"])
    return mesh, cfg


def _resolve_inputs(args):
    """Shared contig/bed/known-site resolution."""
    fasta = FastaFile(args.ref_fn)
    bam = BamReader(args.bam_fn)

    bed_regions = None
    ctg_filter = args.ctg_name
    if args.region:
        from clair3_rna_torch.cli import _parse_region
        ctg, bed_regions = _parse_region(args.region)
        ctg_filter = ctg
    elif args.bed_fn:
        bed_regions = BedRegions.from_file(args.bed_fn)

    contigs = resolve_contigs(bam, fasta, ctg_name=ctg_filter,
                              include_all_ctgs=args.include_all_ctgs,
                              bed_regions=bed_regions)
    if not contigs:
        raise SystemExit("[ERROR] no contigs shared between BAM and reference "
                         "(use --include_all_ctgs for non-standard names)")
    logger.info("[INFO] calling %d contig(s): %s", len(contigs),
                ",".join(contigs[:8]) + ("..." if len(contigs) > 8 else ""))

    known_positions = known_positions_from_vcf(args.vcf_fn) \
        if args.vcf_fn else None
    return contigs, bed_regions, known_positions


def known_positions_from_vcf(vcf_fn):
    """{contig: [0-based positions]} of a -G/--vcf_fn site list."""
    known = {}
    for (ctg, pos) in VcfReader(vcf_fn).variant_dict:
        known.setdefault(ctg, []).append(pos - 1)
    return known


def run_shard_calling(args, cfg, call_cfg: CallConfig, device):
    """One shard worker: write this shard's manifests, no merged VCF (see
    parallel.distributed; merge with the merge_shards subcommand) ->
    ([], CallStats)."""
    from clair3_rna_torch.parallel.distributed import run_sharded_calling

    os.makedirs(args.output_dir, exist_ok=True)
    contigs, bed_regions, known_positions = _resolve_inputs(args)
    mesh, cfg = _mesh_for(args, cfg, device)
    params, forward = load_model(args.model_path, phased=cfg.phased,
                                 device=device, mesh=mesh)
    stats = run_sharded_calling(
        args.bam_fn, args.ref_fn, args.output_dir, cfg=cfg,
        call_cfg=call_cfg, params=params, forward=forward, contigs=contigs,
        n_shards=args.n_shards, shard_id=args.shard_id,
        chunk_size=args.chunk_size, known_vcf_positions=known_positions,
        bed_regions=bed_regions, resume=getattr(args, "resume", False),
        pileup_backend=getattr(args, "pileup_backend", None), device=device)
    logger.info("[INFO] shard %d/%d done: %d candidates, %d rows",
                args.shard_id, args.n_shards, stats.candidates, stats.rows)
    return [], stats


def _attach_run_log(output_dir):
    """Duplicate log records into <output_dir>/run_clair3_rna_torch.log
    (the reference's Tee, run_clair3_rna:75-90)."""
    path = os.path.abspath(
        os.path.join(output_dir, "run_clair3_rna_torch.log"))
    root = logging.getLogger()
    if any(isinstance(h, logging.FileHandler)
           and getattr(h, "baseFilename", None) == path
           for h in root.handlers):
        return
    handler = logging.FileHandler(path)
    handler.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
    root.addHandler(handler)


def run_full_calling(args, cfg, call_cfg: CallConfig):
    """One calling run on args.device (or a mesh of the local cards) ->
    (output paths, CallStats) ((paths, None) for --dry_run; ([], the
    shard's CallStats) for a --n_shards worker). With
    --enable_phasing_model the second pass's outputs follow the first
    pass's, and its CallStats is stats.phased."""
    if getattr(args, "threads", None):
        # the native tile builder partitions the position axis across this
        # many threads (clair3_rna_torch/native: tile_thread_count)
        os.environ.setdefault("CLAIR3_RNA_TORCH_NATIVE_THREADS",
                              str(args.threads))
    if getattr(args, "dry_run", False):
        from clair3_rna_torch.pileup.chunk import plan_chunks
        contigs, bed_regions, _ = _resolve_inputs(args)
        fasta = FastaFile(args.ref_fn)
        tasks = plan_chunks(fasta, contigs=contigs,
                            chunk_size=args.chunk_size or config.CHUNK_SIZE)
        print(f"[DRY RUN] {len(contigs)} contig(s), {len(tasks)} chunk(s):")
        for t in tasks:
            print(f"  {t.ctg_name}\t{t.start}\t{t.end}")
        return [], None
    device = resolve_device(getattr(args, "device", None))
    if getattr(args, "n_shards", None):
        if getattr(args, "shard_id", None) is None:
            raise SystemExit("[ERROR] --n_shards requires --shard_id")
        os.makedirs(args.output_dir, exist_ok=True)
        _attach_run_log(args.output_dir)
        return run_shard_calling(args, cfg, call_cfg, device)
    os.makedirs(args.output_dir, exist_ok=True)
    _attach_run_log(args.output_dir)
    contigs, bed_regions, known_positions = _resolve_inputs(args)
    from clair3_rna_torch.caller.backend import resolve_backend
    backend = resolve_backend(getattr(args, "pileup_backend", None))
    args.pileup_backend = backend

    mesh, cfg = _mesh_for(args, cfg, device)
    params, forward = load_model(args.model_path, phased=cfg.phased,
                                 device=device, mesh=mesh)
    rediportal_path = args.readiportal_source_fn \
        if args.tag_variant_using_readiportal else None
    prefix = getattr(args, "output_prefix", None) or "output"
    output_path = os.path.join(args.output_dir, prefix + ".vcf")
    outputs, stats = run_calling(
        args.bam_fn, args.ref_fn, output_path,
        cfg=cfg, call_cfg=call_cfg, params=params, forward=forward,
        contigs=contigs, chunk_size=args.chunk_size,
        rediportal_path=rediportal_path,
        output_no_tagging_path=os.path.join(
            args.output_dir, prefix + "_no_editing_tagging.vcf"),
        sample_name=args.sample_name,
        cmd_line=" ".join(os.sys.argv),
        compress=not args.no_compress,
        known_vcf_positions=known_positions,
        bed_regions=bed_regions,
        manifest_dir=os.path.join(args.output_dir, "tmp"),
        resume=getattr(args, "resume", False),
        joblog=getattr(args, "joblog", None),
        pileup_backend=backend,
    )
    logger.info("[INFO] pileup calling finished: %s", ", ".join(outputs))

    if getattr(args, "enable_phasing_model", False):
        phased_outputs, stats.phased = run_phasing_pass(
            args, cfg, call_cfg, contigs, outputs[0], device)
        outputs += phased_outputs
    if getattr(args, "remove_intermediate_dir", False):
        import shutil
        for sub in ("tmp", "tmp_phased"):
            tmp_dir = os.path.join(args.output_dir, sub)
            if os.path.isdir(tmp_dir):
                shutil.rmtree(tmp_dir)
                logger.info("[INFO] removed intermediate directory %s",
                            tmp_dir)
    return outputs, stats


def run_phasing_pass(args, cfg, call_cfg, contigs, first_pass_vcf, device):
    """Second pass: phase first-pass hets, haplotag reads, re-call with the
    30-channel phasing model on `device` (run_clair3_rna:729-852) ->
    (output paths, the re-call's CallStats with phase_s set).

    Resumable at two grains, matching the reference's step 3-6 --skip_steps
    (run_clair3_rna:855-867): the phase+haplotag step is skipped when its
    tagged BAM and completion marker (stamped with the first-pass VCF's
    identity) already exist, and the re-call itself checkpoints per chunk
    into <output_dir>/tmp_phased exactly like the first pass."""
    import gzip
    import hashlib
    import json
    import time

    from clair3_rna_torch.phasing.pipeline import phase_and_haplotag

    tagged_bam = os.path.join(args.output_dir, "phased_tagged.bam")
    marker = tagged_bam + ".done.json"
    # identity = the first-pass VCF's BODY content (the header carries
    # ##cmdline, which legitimately differs between a run and its resume;
    # a resume regenerates byte-identical rows, so the body hash is stable
    # exactly when re-phasing would be redundant)
    body = hashlib.sha1()
    opener = gzip.open if first_pass_vcf.endswith(".gz") else open
    with opener(first_pass_vcf, "rb") as f:
        for line in f:
            if not line.startswith(b"#"):
                body.update(line)
    stamp = {
        "first_pass_vcf": os.path.abspath(first_pass_vcf),
        "vcf_body_sha1": body.hexdigest(),
        "phaser": getattr(args, "phaser", "builtin"),
        "contigs": hashlib.sha1(
            ",".join(contigs).encode()).hexdigest()[:12],
    }
    resume = getattr(args, "resume", False)
    done = None
    if resume and os.path.exists(marker) and os.path.exists(tagged_bam):
        try:
            with open(marker) as f:
                done = json.load(f)
        except (OSError, ValueError):
            done = None
    t0 = time.perf_counter()
    if done == stamp:
        logger.info("[INFO] resume: phase+haplotag step restored "
                    "(tagged BAM %s up to date)", tagged_bam)
    else:
        phase_and_haplotag(
            args.bam_fn, args.ref_fn, first_pass_vcf, tagged_bam,
            phaser=getattr(args, "phaser", "builtin"),
            whatshap=getattr(args, "whatshap", "whatshap"),
            longphase=getattr(args, "longphase", "longphase"),
            platform=getattr(args, "platform", "ont"),
            contigs=contigs)
        tmp = marker + ".tmp"
        with open(tmp, "w") as f:
            json.dump(stamp, f)
        os.replace(tmp, marker)  # atomic: BAM is complete when marker lands
    phase_s = time.perf_counter() - t0
    phased_cfg = cfg.with_(phased=True)
    mesh, phased_cfg = _mesh_for(args, phased_cfg, device)
    params, forward = load_model(args.phased_model_path, phased=True,
                                 device=device, mesh=mesh)
    prefix = getattr(args, "output_prefix", None) or "output"
    output_path = os.path.join(args.output_dir, prefix + "_enable_phasing.vcf")
    rediportal_path = args.readiportal_source_fn \
        if args.tag_variant_using_readiportal else None
    joblog = getattr(args, "joblog", None)
    outputs, stats = run_calling(
        tagged_bam, args.ref_fn, output_path,
        cfg=phased_cfg, call_cfg=call_cfg, params=params,
        forward=forward, contigs=contigs, chunk_size=args.chunk_size,
        rediportal_path=rediportal_path,
        output_no_tagging_path=os.path.join(
            args.output_dir, prefix + "_no_tagging_enable_phasing.vcf"),
        sample_name=args.sample_name, compress=not args.no_compress,
        manifest_dir=os.path.join(args.output_dir, "tmp_phased"),
        resume=resume,
        joblog=(joblog + ".phased") if joblog else None,
        pileup_backend=getattr(args, "pileup_backend", None))
    stats.phase_s = phase_s
    logger.info("[INFO] phasing-model calling finished: %s (phase+haplotag "
                "%.3f s, re-call %.3f s)", ", ".join(outputs), phase_s,
                stats.wall_s)
    return outputs, stats
