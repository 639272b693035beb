"""Command-line interface.

Mirrors the user surface of `run_clair3_rna` (run_clair3_rna:881-1254) for
a call on one device, with the optional phased second pass, and the
stand-alone phasing tool:

  python -m clair3_rna_torch call -B reads.bam -R ref.fa -o outdir \\
      -p ont_dorado_drna004 [--device cuda|cpu] [--pileup_backend host|fused]
      [--enable_phasing_model --phased_model_path phased.npz]
  python -m clair3_rna_torch phase_bam --bam_fn reads.bam --ref_fn ref.fa \\
      --vcf_fn calls.vcf --output_bam_fn tagged.bam
"""

import argparse
import logging
import os

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
    p.add_argument("--pileup_backend", choices=["auto", "host", "fused"],
                   default=None,
                   help="pileup formulation: 'host' builds the count image "
                        "on the host C++ tile builder and ships candidate "
                        "windows only; 'fused' stages packed reads on the "
                        "device and runs the whole chunk there (tilelet "
                        "kernel, candidate mask, window gather, network); "
                        "'auto' = host. Default: "
                        "$CLAIR3_RNA_TORCH_PILEUP_BACKEND or 'host'")
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
                        "--joblog analogue, run_clair3_rna:682); profiler "
                        "traces via CLAIR3_RNA_TORCH_PROFILE=<dir>")
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
    from clair3_rna_torch.evaluation.cli_tools import (add_tool_parsers,
                                                       dispatch_tool)
    add_tool_parsers(subparsers)

    args = parser.parse_args(argv)
    try:
        if args.command == "call":
            return run_call(args)
        if dispatch_tool(args):
            return None
    except FileNotFoundError as exc:
        raise SystemExit(
            f"[ERROR] {args.command}: file not found: "
            f"{exc.filename if exc.filename is not None else exc}")
    parser.print_help()
    return None


if __name__ == "__main__":
    main()
