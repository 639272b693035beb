"""Command-line interface.

Mirrors the user surface of `run_clair3_rna` (run_clair3_rna:881-1254): a
call on one device or a dp x tp mesh of the local cards, with the optional
phased second pass, sharded calling across processes and its merge, the
reference's process-level subcommands (create_tensor_pileup, call_var_bam,
call_variants, sort_vcf), the evaluation toolkit and training:

  python -m clair3_rna_torch call -B reads.bam -R ref.fa -o outdir \\
      -p ont_dorado_drna004 [--device cuda|cpu]
      [--pileup_backend host|fused|hybrid]
      [--enable_phasing_model --phased_model_path phased.npz]
      [--n_shards N --shard_id I]  (then merge_shards --work_dir outdir)
  python -m clair3_rna_torch tensor2bin --bam_fn reads.bam --ref_fn ref.fa \\
      --truth_vcf_fn truth.vcf --output_dir bins
  python -m clair3_rna_torch train --bin_dir bins --output_fn w.npz
  python -m clair3_rna_torch create_tensor_pileup --bam_fn reads.bam \\
      --ref_fn ref.fa --ctgName chr1 | \\
      python -m clair3_rna_torch call_variants --chkpnt_fn w.npz
  python -m clair3_rna_torch sort_vcf --input_dir dir --output_fn out.vcf
  python -m clair3_rna_torch phase_bam --bam_fn reads.bam --ref_fn ref.fa \\
      --vcf_fn calls.vcf --output_bam_fn tagged.bam
"""

import argparse
import logging
import os
import sys

from clair3_rna_torch import __version__, config


def _add_call_parser(subparsers):
    p = subparsers.add_parser("call", help="call small variants from an RNA BAM")
    p.add_argument("-B", "--bam_fn", required=True, help="sorted BAM input")
    p.add_argument("-R", "--ref_fn", required=True, help="reference FASTA")
    p.add_argument("-o", "--output_dir", required=True, help="output directory")
    p.add_argument("-p", "--platform", default="ont_dorado_drna004",
                   help="sequencing platform preset "
                        f"({', '.join(sorted(config.SUPPORTED_FULL_PLATFORMS))})")
    p.add_argument("-t", "--threads", type=int, default=os.cpu_count(),
                   help="host worker threads for extraction")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device for the network and the fused pass; "
                        "without CUDA the run fails unless 'cpu' is given")
    p.add_argument("--model_path", "--pileup_model_path",
                   dest="model_path", default=None,
                   help=".npz weights or reference TF checkpoint prefix")
    p.add_argument("--phased_model_path", "--phased_pileup_model_path",
                   dest="phased_model_path", default=None,
                   help="weights for the phasing (30-channel) pass")
    p.add_argument("--ctg_name", default=None,
                   help="comma-separated contigs to call (default: all in BAM)")
    p.add_argument("--region", default=None, help="ctg:start-end region to call")
    p.add_argument("--bed_fn", default=None, help="call only inside these regions")
    p.add_argument("-G", "--genotyping_mode_vcf_fn", "--vcf_fn",
                   dest="vcf_fn", default=None,
                   help="genotyping mode: call genotypes at the sites of this "
                        "VCF only (run_clair3_rna --genotyping_mode_vcf_fn)")
    p.add_argument("--snp_min_af", type=float, default=config.SNP_MIN_AF)
    p.add_argument("--indel_min_af", type=float, default=config.INDEL_MIN_AF)
    p.add_argument("--min_coverage", type=int, default=config.MIN_COVERAGE)
    p.add_argument("--min_mq", type=int, default=config.MIN_MQ)
    p.add_argument("--min_bq", type=int, default=config.MIN_BQ)
    p.add_argument("--qual", type=float, default=None,
                   help="LowQual threshold (default: platform preset)")
    p.add_argument("--chunk_size", type=int, default=config.CHUNK_SIZE)
    p.add_argument("--batch_size", type=int, default=2048)
    p.add_argument("--sample_name", default="SAMPLE")
    p.add_argument("--print_ref_calls", action="store_true",
                   help="show reference calls (RefCall) in VCF")
    p.add_argument("--gvcf", action="store_true", help="also produce GVCF output")
    p.add_argument("--base_err", type=float, default=config.BASE_ERR,
                   help="assumed per-base error for GVCF reference "
                        "likelihoods (shared/param_p.py:26)")
    p.add_argument("--gq_bin_size", type=int, default=config.GQ_BIN_SIZE,
                   help="GQ bin width for GVCF non-variant blocks")
    p.add_argument("--bp_resolution", action="store_true",
                   help="emit per-base GVCF records instead of blocks")
    p.add_argument("--pileup_backend",
                   choices=["auto", "host", "fused", "hybrid"],
                   default=None,
                   help="pileup formulation: 'host' builds the count image "
                        "on the host C++ tile builder and ships candidate "
                        "windows only; 'fused' stages packed reads on the "
                        "device and runs the whole chunk there (tilelet "
                        "kernel, candidate mask, window gather, network); "
                        "'hybrid' routes each chunk to the route with the "
                        "lower wall measured during the run; 'auto' = "
                        "host. Default: $CLAIR3_RNA_TORCH_PILEUP_BACKEND or "
                        "'host'")
    p.add_argument("--fast_mode", action="store_true")
    p.add_argument("--call_snp_only", action="store_true")
    p.add_argument("--enable_phasing_model", action="store_true",
                   help="run the second, haplotagged-read calling pass")
    p.add_argument("--phaser", choices=["builtin", "whatshap", "longphase"],
                   default="builtin",
                   help="phasing engine for the second pass: in-framework "
                        "pairwise linkage (default) or an installed external "
                        "phaser (run_clair3_rna:729-801 invocations)")
    p.add_argument("--whatshap", default="whatshap",
                   help="whatshap executable path (with --phaser whatshap)")
    p.add_argument("--longphase", default="longphase",
                   help="longphase executable path (with --phaser longphase)")
    p.add_argument("--enable_variant_calling_at_sequence_head_and_tail",
                   action="store_true")
    p.add_argument("--enable_padding_in_splice_junction_regions",
                   action="store_true")
    p.add_argument("--enable_long_indel", action="store_true")
    p.add_argument("--keep_iupac_bases", action="store_true")
    p.add_argument("--haploid_precise", action="store_true")
    p.add_argument("--haploid_sensitive", action="store_true")
    p.add_argument("--tag_variant_using_readiportal", action="store_true")
    p.add_argument("--readiportal_source_fn", default=None)
    p.add_argument("--readiportal_reference_genome_version", default=None,
                   choices=["grch38", "grch37"],
                   help="pick the bundled REDIportal table when "
                        "--readiportal_source_fn is not given "
                        "(run_clair3_rna:497-515; table dir from "
                        "$CLAIR3_RNA_TORCH_MODELS_DIR)")
    p.add_argument("--readiportal_database_filter_tag",
                   default=config.REDIPORTAL_FILTER_TAGS)
    p.add_argument("--include_all_ctgs", action="store_true")
    p.add_argument("--no_compress", action="store_true")
    p.add_argument("--output_prefix", default="output",
                   help="basename for the merged VCF outputs")
    p.add_argument("--remove_intermediate_dir", action="store_true",
                   help="delete <output_dir>/tmp (and tmp_phased) after a "
                        "successful run")
    p.add_argument("--resume", action="store_true",
                   help="restore finished contigs and finished chunks of "
                        "partial contigs from a previous run's manifests "
                        "under <output_dir>/tmp; only unfinished chunks "
                        "are redone")
    p.add_argument("--joblog", default=None,
                   help="write a per-chunk timing TSV (the GNU parallel "
                        "--joblog analogue, run_clair3_rna:682): contig, "
                        "start, end, candidates, build_seconds, route "
                        "(fused|host|fallback), worker, starttime, "
                        "donetime (epoch s), wait_s, the fused pass's "
                        "extract_s, stage_s, h2d_s, launch_s, sync_s, "
                        "escape_s, decode_s, staged_rows, k1_bytes, "
                        "budget, retries; profiler traces of every thread "
                        "via CLAIR3_RNA_TORCH_PROFILE=<dir>")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel width of the device mesh")
    p.add_argument("--no_device_mesh", action="store_true",
                   help="single-device inference even with multiple devices")
    p.add_argument("--n_shards", type=int, default=None,
                   help="multi-host mode: total number of contig-shard "
                        "workers; this process only writes shard manifests")
    p.add_argument("--shard_id", type=int, default=None,
                   help="multi-host mode: this worker's shard index")
    p.add_argument("--dry_run", action="store_true",
                   help="print the resolved contig/chunk plan and exit "
                        "without calling")
    return p


def _parse_region(region):
    """ctg:start-end (1-based, inclusive) -> BedRegions matching the
    reference's quirk of using end-1 as the half-open end
    (shared/interval_tree.py:22-32)."""
    from clair3_rna_torch.io.bed import BedRegions
    ctg, start_end = region.split(":")
    start, end = start_end.split("-")
    lo, hi = int(start) - 1, int(end) - 1
    if hi < lo or lo < 0:
        raise SystemExit(f"[ERROR] invalid region: {region}")
    return ctg, BedRegions({ctg: [(lo, max(hi, lo + 1))]})


def run_call(args):
    """`call` subcommand -> (output paths, CallStats)."""
    from clair3_rna_torch.config import PileupConfig
    from clair3_rna_torch.caller.decode import CallConfig
    from clair3_rna_torch.caller.driver import run_full_calling

    full_platform = config.PLATFORM_ALIASES.get(args.platform, args.platform)
    if full_platform not in config.SUPPORTED_FULL_PLATFORMS \
            and full_platform not in config.SUPPORTED_PLATFORMS:
        raise SystemExit(f"[ERROR] unsupported platform {args.platform}")

    if args.tag_variant_using_readiportal and args.readiportal_source_fn is None:
        # bundled-table resolution by genome build (run_clair3_rna:497-515)
        version = args.readiportal_reference_genome_version or "grch38"
        table = "TABLE1_hg38.txt.gz" if version == "grch38" \
            else "TABLE1_hg19.txt.gz"
        models_dir = os.environ.get("CLAIR3_RNA_TORCH_MODELS_DIR")
        candidate = os.path.join(models_dir, table) if models_dir else None
        if candidate is None or not os.path.exists(candidate):
            raise SystemExit(
                f"[ERROR] REDIportal table {table} not found; pass "
                "--readiportal_source_fn or set $CLAIR3_RNA_TORCH_MODELS_DIR")
        args.readiportal_source_fn = candidate

    cfg = PileupConfig.for_platform(
        full_platform,
        min_mq=args.min_mq, min_bq=args.min_bq,
        min_coverage=args.min_coverage,
        snp_min_af=args.snp_min_af, indel_min_af=args.indel_min_af,
        fast_mode=args.fast_mode, call_snp_only=args.call_snp_only,
        enable_head_tail=args.enable_variant_calling_at_sequence_head_and_tail,
        enable_splice_padding=args.enable_padding_in_splice_junction_regions,
        show_ref=args.print_ref_calls,
        qual_cutoff=args.qual,
        enable_long_indel=args.enable_long_indel,
        sample_name=args.sample_name,
        batch_size=args.batch_size,
    )
    call_cfg = CallConfig(
        show_ref=args.print_ref_calls, qual=None, gvcf=args.gvcf,
        enable_long_indel=args.enable_long_indel,
        keep_iupac_bases=args.keep_iupac_bases,
        haploid_precise=args.haploid_precise,
        haploid_sensitive=args.haploid_sensitive,
        gvcf_p_err=args.base_err,
        gvcf_gq_bin_size=args.gq_bin_size,
        gvcf_bp_resolution=args.bp_resolution,
    )
    return run_full_calling(args, cfg, call_cfg)


_DEVICE_HELP = ("device for the network (and the pure-array builder's counts "
                "under CLAIR3_RNA_TORCH_PILEUP_BACKEND=device|kernel); "
                "without CUDA the run fails unless 'cpu' is given")


def _add_interop_parsers(subparsers):
    t = subparsers.add_parser(
        "create_tensor_pileup",
        help="emit reference-format tensor TSV rows for one contig/chunk "
             "(src/create_tensor_pileup.py process equivalent)")
    t.add_argument("--bam_fn", required=True)
    t.add_argument("--ref_fn", required=True)
    t.add_argument("--tensor_can_fn", default="PIPE",
                   help="output path, or PIPE for stdout")
    t.add_argument("--ctgName", "--ctg_name", dest="ctg_name", default=None)
    t.add_argument("--chunk_id", type=int, default=None, help="1-based")
    t.add_argument("--chunk_num", type=int, default=None)
    t.add_argument("--region", default=None, help="ctg:start-end")
    t.add_argument("--bed_fn", default=None)
    t.add_argument("--vcf_fn", default=None, help="known-site genotyping list")
    t.add_argument("--platform", default="ont_dorado_drna004")
    t.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help=_DEVICE_HELP)
    t.add_argument("--snp_min_af", type=float, default=config.SNP_MIN_AF)
    t.add_argument("--indel_min_af", type=float, default=config.INDEL_MIN_AF)
    t.add_argument("--min_coverage", type=int, default=config.MIN_COVERAGE)
    t.add_argument("--minMQ", "--min_mq", dest="min_mq", type=int,
                   default=config.MIN_MQ)
    t.add_argument("--minBQ", "--min_bq", dest="min_bq", type=int,
                   default=config.MIN_BQ)
    t.add_argument("--fast_mode", action="store_true")
    t.add_argument("--call_snp_only", action="store_true")
    t.add_argument("--phased", action="store_true",
                   help="30-channel haplotagged tensors (phasing model pass)")
    t.add_argument("--enable_variant_calling_at_sequence_head_and_tail",
                   action="store_true")
    t.add_argument("--enable_padding_in_splice_junction_regions",
                   action="store_true")

    b = subparsers.add_parser(
        "call_var_bam",
        help="call one contig/chunk BAM region to a per-chunk VCF "
             "(clair3_rna/call_var_bam.py process equivalent, in-process)")
    b.add_argument("--bam_fn", required=True)
    b.add_argument("--ref_fn", required=True)
    b.add_argument("--chkpnt_fn", "--model_path", dest="model_path",
                   default=None, help=".npz weights or TF checkpoint prefix")
    b.add_argument("--call_fn", default="PIPE",
                   help="per-chunk VCF output path (e.g. pileup_chr1_3.vcf), "
                        "or PIPE for stdout")
    b.add_argument("--ctgName", "--ctg_name", dest="ctg_name", default=None)
    b.add_argument("--ctgStart", dest="ctg_start", type=int, default=None,
                   help="1-based inclusive region start")
    b.add_argument("--ctgEnd", dest="ctg_end", type=int, default=None,
                   help="1-based inclusive region end")
    b.add_argument("--chunk_id", type=int, default=None, help="1-based")
    b.add_argument("--chunk_num", type=int, default=None)
    b.add_argument("--bed_fn", default=None)
    b.add_argument("--vcf_fn", default=None, help="known-site genotyping list")
    b.add_argument("--platform", default="ont_dorado_drna004")
    b.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help=_DEVICE_HELP)
    b.add_argument("--sampleName", "--sample_name", dest="sample_name",
                   default="SAMPLE")
    b.add_argument("--batch_size", type=int, default=2048)
    b.add_argument("--snp_min_af", type=float, default=config.SNP_MIN_AF)
    b.add_argument("--indel_min_af", type=float, default=config.INDEL_MIN_AF)
    b.add_argument("--minCoverage", "--min_coverage", dest="min_coverage",
                   type=int, default=config.MIN_COVERAGE)
    b.add_argument("--minMQ", "--min_mq", dest="min_mq", type=int,
                   default=config.MIN_MQ)
    b.add_argument("--minBQ", "--min_bq", dest="min_bq", type=int,
                   default=config.MIN_BQ)
    b.add_argument("--fast_mode", action="store_true")
    b.add_argument("--call_snp_only", action="store_true")
    b.add_argument("--show_ref", "--showRef", dest="show_ref",
                   action="store_true")
    b.add_argument("--qual", type=float, default=None)
    b.add_argument("--enable_long_indel", action="store_true")
    b.add_argument("--keep_iupac_bases", action="store_true")
    b.add_argument("--haploid_precise", action="store_true")
    b.add_argument("--haploid_sensitive", action="store_true")
    b.add_argument("--phasing_info_in_bam", "--phased", dest="phased",
                   action="store_true",
                   help="30-channel phased tensors from an HP-tagged BAM")
    b.add_argument("--enable_variant_calling_at_sequence_head_and_tail",
                   action="store_true")
    b.add_argument("--enable_padding_in_splice_junction_regions",
                   action="store_true")

    v = subparsers.add_parser(
        "call_variants",
        help="tensor TSV in (stdin or file), VCF rows out "
             "(clair3_rna/call_variants.py process equivalent)")
    v.add_argument("--tensor_fn", default="PIPE",
                   help="input tensor TSV path, or PIPE for stdin")
    v.add_argument("--call_fn", default="PIPE",
                   help="output VCF rows path, or PIPE for stdout")
    v.add_argument("--chkpnt_fn", "--model_path", dest="model_path",
                   default=None, help=".npz weights or TF checkpoint prefix")
    v.add_argument("--platform", default="ont_dorado_drna004")
    v.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help=_DEVICE_HELP)
    v.add_argument("--batch_size", type=int, default=2048)
    v.add_argument("--show_ref", "--showRef", dest="show_ref",
                   action="store_true")
    v.add_argument("--qual", type=float, default=None)
    v.add_argument("--enable_long_indel", action="store_true")
    v.add_argument("--keep_iupac_bases", action="store_true")
    v.add_argument("--haploid_precise", action="store_true")
    v.add_argument("--haploid_sensitive", action="store_true")
    v.add_argument("--debug", action="store_true",
                   help="print raw probability rows instead of VCF rows "
                        "(clair3_rna/call_variants.py --debug)")
    v.add_argument("--output_for_ensemble", action="store_true",
                   help="emit per-candidate probability rows for ensemble "
                        "calling instead of VCF rows "
                        "(clair3_rna/call_variants.py --output_for_ensemble)")
    v.add_argument("--phased", action="store_true",
                   help="expect 30-channel phased tensors")


def _run_create_tensor(args):
    from clair3_rna_torch.caller.driver import known_positions_from_vcf
    from clair3_rna_torch.caller.tsv_interop import (open_maybe_stdout,
                                                     write_tensor_rows)
    from clair3_rna_torch.config import PileupConfig
    from clair3_rna_torch.io.bed import BedRegions

    full_platform = config.PLATFORM_ALIASES.get(args.platform, args.platform)
    cfg = PileupConfig.for_platform(
        full_platform,
        min_mq=args.min_mq, min_bq=args.min_bq,
        min_coverage=args.min_coverage,
        snp_min_af=args.snp_min_af, indel_min_af=args.indel_min_af,
        fast_mode=args.fast_mode, call_snp_only=args.call_snp_only,
        phased=args.phased,
        enable_head_tail=args.enable_variant_calling_at_sequence_head_and_tail,
        enable_splice_padding=args.enable_padding_in_splice_junction_regions)
    region = None
    bed_regions = None
    if args.region:
        ctg, bed = _parse_region(args.region)
        region = (ctg, (int(bed.starts[ctg][0]), int(bed.ends[ctg][0])))
    elif args.bed_fn:
        bed_regions = BedRegions.from_file(args.bed_fn)
    known_positions = known_positions_from_vcf(args.vcf_fn) \
        if args.vcf_fn else None
    out, owns = open_maybe_stdout(args.tensor_can_fn)
    try:
        n = write_tensor_rows(args.bam_fn, args.ref_fn, out, cfg=cfg,
                              ctg_name=args.ctg_name, chunk_id=args.chunk_id,
                              chunk_num=args.chunk_num, region=region,
                              bed_regions=bed_regions,
                              known_positions=known_positions,
                              device=args.device)
    finally:
        if owns:
            out.close()
    print(f"[INFO] wrote {n} tensor rows", file=sys.stderr)


def _run_call_var_bam(args):
    """One (contig, chunk) BAM region -> per-chunk VCF, in-process.

    The reference's call_var_bam (clair3_rna/call_var_bam.py:88-333) spawns a
    pypy tensor builder piped into a python caller; here the same unit of
    work (one chunk of one contig, addressed by --chunk_id/--chunk_num or
    --ctgStart/--ctgEnd) runs as one in-process chain on --device, so
    GNU-parallel style drivers can still fan out per-chunk workers."""
    from clair3_rna_torch.caller.decode import CallConfig
    from clair3_rna_torch.caller.driver import (known_positions_from_vcf,
                                                load_model)
    from clair3_rna_torch.caller.pipeline import call_tensor_records
    from clair3_rna_torch.caller.tsv_interop import open_maybe_stdout
    from clair3_rna_torch.config import PileupConfig
    from clair3_rna_torch.io.bed import BedRegions
    from clair3_rna_torch.io.fasta import FastaFile
    from clair3_rna_torch.io.vcf import vcf_header
    from clair3_rna_torch.pileup.chunk import (ChunkTask, build_chunk_tensors,
                                               open_bam, tasks_for_chunk_args)

    full_platform = config.PLATFORM_ALIASES.get(args.platform, args.platform)
    cfg = PileupConfig.for_platform(
        full_platform,
        min_mq=args.min_mq, min_bq=args.min_bq,
        min_coverage=args.min_coverage,
        snp_min_af=args.snp_min_af, indel_min_af=args.indel_min_af,
        fast_mode=args.fast_mode, call_snp_only=args.call_snp_only,
        phased=args.phased, show_ref=args.show_ref,
        enable_head_tail=args.enable_variant_calling_at_sequence_head_and_tail,
        enable_splice_padding=args.enable_padding_in_splice_junction_regions,
        sample_name=args.sample_name, batch_size=args.batch_size)
    call_cfg = CallConfig(
        show_ref=args.show_ref, qual=args.qual,
        enable_long_indel=args.enable_long_indel,
        keep_iupac_bases=args.keep_iupac_bases,
        haploid_precise=args.haploid_precise,
        haploid_sensitive=args.haploid_sensitive)

    params, forward = load_model(args.model_path, phased=args.phased,
                                 device=args.device)
    fasta = FastaFile(args.ref_fn)
    bam = open_bam(args.bam_fn)
    if args.ctg_start is not None or args.ctg_end is not None:
        if not args.ctg_name or args.ctg_start is None or args.ctg_end is None:
            raise SystemExit("[ERROR] --ctgStart/--ctgEnd need --ctgName and "
                             "both bounds")
        tasks = [ChunkTask(args.ctg_name, max(args.ctg_start - 1, 0),
                           args.ctg_end)]
    else:
        tasks = tasks_for_chunk_args(fasta, bam, ctg_name=args.ctg_name,
                                     chunk_id=args.chunk_id,
                                     chunk_num=args.chunk_num)
    bed_regions = BedRegions.from_file(args.bed_fn) if args.bed_fn else None
    known_positions = known_positions_from_vcf(args.vcf_fn) \
        if args.vcf_fn else None

    out, owns = open_maybe_stdout(args.call_fn)
    n_rows = 0
    try:
        out.write(vcf_header(args.ref_fn,
                             sample_name=args.sample_name).rstrip("\n") + "\n")
        for task in tasks:
            records = build_chunk_tensors(
                bam, fasta, task, cfg,
                known_positions=known_positions.get(task.ctg_name)
                if known_positions else None,
                bed_regions=bed_regions, device=params.device)
            for row in call_tensor_records(records, forward, params, cfg,
                                           call_cfg):
                out.write(row + "\n")
                n_rows += 1
    finally:
        if owns:
            out.close()
    print(f"[INFO] wrote {n_rows} VCF rows", file=sys.stderr)


def _run_call_variants(args):
    from clair3_rna_torch.caller.decode import CallConfig
    from clair3_rna_torch.caller.driver import load_model
    from clair3_rna_torch.caller.tsv_interop import (call_variants_from_tsv,
                                                     open_maybe_stdout,
                                                     open_tensor_stream)
    from clair3_rna_torch.config import PileupConfig

    full_platform = config.PLATFORM_ALIASES.get(args.platform, args.platform)
    cfg = PileupConfig.for_platform(full_platform, phased=args.phased,
                                    batch_size=args.batch_size)
    call_cfg = CallConfig(
        show_ref=args.show_ref, qual=args.qual,
        enable_long_indel=args.enable_long_indel,
        keep_iupac_bases=args.keep_iupac_bases,
        haploid_precise=args.haploid_precise,
        haploid_sensitive=args.haploid_sensitive,
        debug=args.debug)
    params, forward = load_model(args.model_path, phased=args.phased,
                                 device=args.device)
    in_stream, owns_in = open_tensor_stream(args.tensor_fn)
    out, owns = open_maybe_stdout(args.call_fn)
    try:
        n = call_variants_from_tsv(in_stream, out, cfg=cfg, call_cfg=call_cfg,
                                   params=params, forward=forward,
                                   ensemble=args.output_for_ensemble)
    finally:
        if owns:
            out.close()
        if owns_in:
            in_stream.close()
    print(f"[INFO] wrote {n} VCF rows", file=sys.stderr)


def _add_index_parser(subparsers):
    p = subparsers.add_parser(
        "index",
        help="build a BAI index for a coordinate-sorted BAM "
             "(samtools-index equivalent; enables bounded-memory region "
             "access for whole-genome inputs)")
    p.add_argument("bam_fn", help="coordinate-sorted BAM to index")
    p.add_argument("-o", "--output_fn", default=None,
                   help="index output path (default: <bam>.bai)")
    return p


def _run_index(args):
    from clair3_rna_torch.io.bai import build_index

    out = args.output_fn or args.bam_fn + ".bai"
    build_index(args.bam_fn, out)
    print(f"[INFO] wrote {out}")


def _add_sort_parser(subparsers):
    p = subparsers.add_parser("sort_vcf", help="merge/sort per-chunk VCFs")
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_fn", required=True)
    p.add_argument("--vcf_fn_prefix", default="pileup_")
    p.add_argument("--ref_fn", default=None)
    p.add_argument("--contigs_fn", default=None)
    p.add_argument("--sample_name", default="SAMPLE")
    p.add_argument("--qual", type=float, default=None)
    p.add_argument("--show_ref", action="store_true")
    p.add_argument("--tag_variant_using_readiportal", action="store_true")
    p.add_argument("--readiportal_source_fn", default=None)
    p.add_argument("--output_no_tagging_fn", default=None)
    p.add_argument("--no_compress", action="store_true")

    m = subparsers.add_parser(
        "merge_shards",
        help="merge contig-shard manifests from `call --n_shards` workers "
             "into one sorted VCF")
    m.add_argument("--work_dir", required=True,
                   help="the shard workers' shared --output_dir")
    m.add_argument("--n_shards", type=int, required=True)
    m.add_argument("--output_fn", required=True)
    m.add_argument("--ref_fn", default=None)
    m.add_argument("--sample_name", default="SAMPLE")
    m.add_argument("--qual", type=float, default=None)
    m.add_argument("--show_ref", action="store_true")
    m.add_argument("--platform", default="ont_dorado_drna004")
    m.add_argument("--no_compress", action="store_true")
    return p


def _run_merge_shards(args):
    from clair3_rna_torch.config import PileupConfig
    from clair3_rna_torch.parallel.distributed import merge_shards

    full_platform = config.PLATFORM_ALIASES.get(args.platform, args.platform)
    cfg = PileupConfig.for_platform(full_platform, qual_cutoff=args.qual)
    outputs, n_rows, n_tagged = merge_shards(
        args.work_dir, args.n_shards, args.output_fn,
        show_ref=args.show_ref, qual_cutoff=cfg.effective_qual_cutoff,
        reference_file_path=args.ref_fn, sample_name=args.sample_name,
        compress=not args.no_compress)
    print(f"[INFO] merged {args.n_shards} shards -> "
          f"{', '.join(outputs)} ({n_rows} rows)")
    return outputs


def run_sort(args):
    from clair3_rna_torch.postprocess.sort_vcf import (load_rediportal,
                                                       sort_vcf_files)

    if args.contigs_fn and os.path.exists(args.contigs_fn):
        contigs = [line.strip() for line in open(args.contigs_fn)
                   if line.strip()]
    else:
        contigs = sorted({fn.split("_")[1] for fn in os.listdir(args.input_dir)
                          if fn.startswith(args.vcf_fn_prefix)})
    rediportal = load_rediportal(
        args.readiportal_source_fn if args.tag_variant_using_readiportal
        else None, contigs=contigs)
    outputs, n_rows, n_tagged = sort_vcf_files(
        args.input_dir, args.output_fn, contigs,
        vcf_fn_prefix=args.vcf_fn_prefix,
        show_ref=args.show_ref, qual_cutoff=args.qual,
        rediportal=rediportal,
        output_no_tagging_fn=args.output_no_tagging_fn if rediportal else None,
        reference_file_path=args.ref_fn, sample_name=args.sample_name,
        compress=not args.no_compress)
    print(f"[INFO] wrote {n_rows} rows ({n_tagged} RNAEditing-tagged) "
          f"-> {', '.join(outputs)}")


def main(argv=None):
    """Entry point; `call` returns (output paths, CallStats)."""
    logging.basicConfig(format="%(message)s", level=logging.INFO)
    parser = argparse.ArgumentParser(
        prog="clair3_rna_torch",
        description=f"Clair3-RNA on PyTorch/CUDA v{__version__}: long-read "
                    "RNA-seq small variant calling")
    parser.add_argument("--version", action="version",
                        version=f"clair3_rna_torch {__version__}")
    subparsers = parser.add_subparsers(dest="command")
    _add_call_parser(subparsers)
    _add_sort_parser(subparsers)
    _add_index_parser(subparsers)
    _add_interop_parsers(subparsers)
    from clair3_rna_torch.evaluation.cli_tools import (add_tool_parsers,
                                                       dispatch_tool)
    from clair3_rna_torch.train.cli_tools import (add_train_parsers,
                                                  dispatch_train)
    add_tool_parsers(subparsers)
    add_train_parsers(subparsers)

    args = parser.parse_args(argv)
    try:
        if args.command == "call":
            return run_call(args)
        if args.command == "sort_vcf":
            return run_sort(args)
        if args.command == "merge_shards":
            return _run_merge_shards(args)
        if args.command == "create_tensor_pileup":
            return _run_create_tensor(args)
        if args.command == "call_var_bam":
            return _run_call_var_bam(args)
        if args.command == "call_variants":
            return _run_call_variants(args)
        if args.command == "index":
            return _run_index(args)
        if dispatch_tool(args) or dispatch_train(args):
            return None
    except FileNotFoundError as exc:
        raise SystemExit(
            f"[ERROR] {args.command}: file not found: "
            f"{exc.filename if exc.filename is not None else exc}")
    parser.print_help()
    return None


if __name__ == "__main__":
    main()
