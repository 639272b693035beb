"""CLI subcommands for the evaluation toolkit and the stand-alone phasing
tool. The tools that build pileups (the AF distributions, silver editing
sites, the genotyping add-back) take --device: the pure-array builder takes
its channel counts there under CLAIR3_RNA_TORCH_PILEUP_BACKEND=device|kernel
(kernel: the count kernel, K4, on a card), while the host backend touches
no device."""

_DEVICE_HELP = ("device for the pileup builder's channel counts under "
                "CLAIR3_RNA_TORCH_PILEUP_BACKEND=device|kernel; without CUDA "
                "those backends fail unless 'cpu' is given")


def _add_device(parser):
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help=_DEVICE_HELP)


def add_tool_parsers(subparsers):
    p = subparsers.add_parser("compare_vcf", help="benchmark calls vs truth VCF")
    p.add_argument("--vcf_fn", required=True, help="called VCF")
    p.add_argument("--truth_vcf_fn", required=True)
    p.add_argument("--bed_fn", default=None, help="high-confidence regions")
    p.add_argument("--ctg_name", default=None)
    p.add_argument("--qual", type=float, default=None)
    p.add_argument("--skip_genotyping", action="store_true",
                   help="count allele matches as TP regardless of zygosity")
    p.add_argument("--best_f1", action="store_true",
                   help="sweep QUAL cutoffs for the best F1")
    p.add_argument("--roc_fn", default=None,
                   help="write a qual-threshold ROC table "
                        "(src/compare_vcf.py --roc_fn equivalent)")
    p.add_argument("--output_dir", default=None,
                   help="dump per-class tp/fp/fn/fp_fn VCFs here "
                        "(src/compare_vcf.py --output_dir equivalent)")

    t = subparsers.add_parser("phase_bam",
                              help="read-backed phasing + HP haplotagging")
    t.add_argument("--bam_fn", required=True)
    t.add_argument("--ref_fn", required=True)
    t.add_argument("--vcf_fn", required=True, help="first-pass het calls")
    t.add_argument("--output_bam_fn", required=True)
    t.add_argument("--ctg_name", default=None)
    t.add_argument("--phaser", choices=["builtin", "whatshap", "longphase"],
                   default="builtin",
                   help="phasing engine: in-framework pairwise linkage "
                        "(default) or an installed external phaser with the "
                        "reference's invocations (run_clair3_rna:729-801)")
    t.add_argument("--whatshap", default="whatshap",
                   help="whatshap executable path")
    t.add_argument("--longphase", default="longphase",
                   help="longphase executable path")

    b = subparsers.add_parser("get_rna_bed",
                              help="coverage >= N BED from a BAM (mosdepth+"
                                   "bedtools replacement)")
    b.add_argument("--bam_fn", required=True)
    b.add_argument("--output_fn", required=True)
    b.add_argument("--min_coverage", type=int, default=4)
    b.add_argument("--high_conf_bed_fn", default=None,
                   help="intersect with this BED (e.g. GIAB high-confidence)")

    a = subparsers.add_parser(
        "cal_truth_vcf_af_distribution",
        help="per-truth-site coverage/alt support for stratified benchmarking "
             "(src/cal_truth_vcf_af_distribution.py equivalent)")
    a.add_argument("--bam_fn", required=True)
    a.add_argument("--ref_fn", required=True)
    a.add_argument("--truth_vcf_fn", required=True)
    a.add_argument("--output_fn", required=True, help="'truths' support file")
    a.add_argument("--ctg_name", default=None)
    a.add_argument("--with_hp", action="store_true",
                   help="also break counts down by HP haplotag")
    _add_device(a)

    pa = subparsers.add_parser(
        "cal_af_distribution",
        help="tumor/normal per-truth-site depth and alt support "
             "(src/cal_af_distribution.py equivalent)")
    pa.add_argument("--normal_bam_fn", default=None)
    pa.add_argument("--tumor_bam_fn", default=None)
    pa.add_argument("--ref_fn", required=True)
    pa.add_argument("--truth_vcf_fn", required=True)
    pa.add_argument("--output_fn", required=True)
    pa.add_argument("--ctg_name", default=None)
    _add_device(pa)

    f = subparsers.add_parser(
        "get_truth_from_af",
        help="drop truth variants without RNA read support or with "
             "zygosity/AF mismatch (src/get_truth_from_af.py equivalent)")
    f.add_argument("--truth_vcf_fn", required=True)
    f.add_argument("--truths_fn", required=True,
                   help="support file from cal_truth_vcf_af_distribution")
    f.add_argument("--output_fn", required=True)
    f.add_argument("--min_coverage", type=int, default=4)
    f.add_argument("--min_alt_coverage", type=int, default=2)
    f.add_argument("--hom_min_af", type=float, default=0.2)
    f.add_argument("--het_max_af", type=float, default=0.8)

    s = subparsers.add_parser(
        "call_silver_editing_site",
        help="A-to-G / T-to-C silver RNA-editing candidate sites "
             "(src/call_silver_editing_site.py equivalent)")
    s.add_argument("--bam_fn", required=True, help="RNA BAM")
    s.add_argument("--ref_fn", required=True)
    s.add_argument("--dna_bam_fn", default=None,
                   help="matched DNA BAM for the DNA-AF exclusion test")
    s.add_argument("--output_fn", required=True)
    s.add_argument("--ctg_name", default=None)
    s.add_argument("--rna_min_af", type=float, default=0.75)
    s.add_argument("--dsrna_min_af", type=float, default=0.4)
    s.add_argument("--dsrna_bed_fn", default=None)
    s.add_argument("--dna_max_af", type=float, default=0.25)
    s.add_argument("--dna_min_depth", type=int, default=8)
    s.add_argument("--min_coverage", type=int, default=4)
    _add_device(s)

    m = subparsers.add_parser(
        "calculate_overall_metrics",
        help="coverage/AF-stratified P/R/F1 vs truth, or hap.py-annotated "
             "VCF ingestion (src/calculate_overall_metrics.py equivalent)")
    m.add_argument("--vcf_fn", "--input_vcf_fn", dest="vcf_fn", default=None,
                   help="called VCF")
    m.add_argument("--truth_vcf_fn", default=None)
    m.add_argument("--happy_vcf_fn", default=None,
                   help="hap.py-annotated output VCF (BD/BI/BVT/BK tags); "
                        "the reference's published-metrics pathway")
    m.add_argument("--truths_fn", "--truths_info_fn", dest="truths_fn",
                   default=None,
                   help="support file from cal_truth_vcf_af_distribution")
    m.add_argument("--bed_fn", default=None)
    m.add_argument("--ctg_name", default=None)
    m.add_argument("--min_coverage", type=int, default=None)
    m.add_argument("--min_alt_coverage", type=int, default=None)
    m.add_argument("--min_af", type=float, default=None)
    m.add_argument("--min_qual", type=float, default=None)
    m.add_argument("--input_filter_tag", default=None)
    m.add_argument("--skip_genotyping", action="store_true")
    m.add_argument("--output_fn", default=None)
    m.add_argument("--output_best_f1_score", action="store_true")

    g = subparsers.add_parser(
        "add_back_missing_variants_in_genotyping",
        help="re-insert uncalled genotyping sites as ./. rows "
             "(src/add_back_missing_variants_in_genotyping.py equivalent)")
    g.add_argument("--vcf_fn", required=True, help="called VCF")
    g.add_argument("--sites_vcf_fn", required=True,
                   help="the -G/--vcf_fn genotyping site list")
    g.add_argument("--bam_fn", required=True)
    g.add_argument("--ref_fn", required=True)
    g.add_argument("--output_fn", required=True)
    _add_device(g)

    c = subparsers.add_parser(
        "concat_files", help="concatenate per-chunk outputs by prefix/suffix "
                             "(src/concat_files.py equivalent)")
    c.add_argument("--input_dir", required=True)
    c.add_argument("--output_fn", required=True)
    c.add_argument("--prefix", default=None)
    c.add_argument("--suffix", default=None)
    c.add_argument("--keep_all_headers", action="store_true")


def dispatch_tool(args) -> bool:
    """Run the tool subcommand `args.command`; False if it is not one."""
    if args.command == "compare_vcf":
        from clair3_rna_torch.evaluation.compare_vcf import (
            best_f1_qual_sweep, compare_vcf, dump_site_vcfs, print_report,
            write_roc)
        if args.best_f1:
            q, result = best_f1_qual_sweep(
                args.vcf_fn, args.truth_vcf_fn, bed_fn=args.bed_fn,
                ctg_name=args.ctg_name, skip_genotyping=args.skip_genotyping)
            print_report(result, title=f"best F1 at QUAL>={q}")
        else:
            result = compare_vcf(
                args.vcf_fn, args.truth_vcf_fn, bed_fn=args.bed_fn,
                ctg_name=args.ctg_name, min_qual=args.qual,
                skip_genotyping=args.skip_genotyping)
            print_report(result)
        if args.roc_fn:
            write_roc(result, args.vcf_fn, args.roc_fn,
                      ctg_name=args.ctg_name)
            print(f"[INFO] ROC table -> {args.roc_fn}")
        if args.output_dir:
            paths = dump_site_vcfs(result, args.vcf_fn, args.truth_vcf_fn,
                                   args.output_dir, ctg_name=args.ctg_name)
            print(f"[INFO] per-class VCFs -> {', '.join(paths.values())}")
        return True
    if args.command == "phase_bam":
        from clair3_rna_torch.phasing.pipeline import phase_and_haplotag
        contigs = args.ctg_name.split(",") if args.ctg_name else None
        phase_and_haplotag(args.bam_fn, args.ref_fn, args.vcf_fn,
                           args.output_bam_fn, contigs=contigs,
                           phaser=args.phaser, whatshap=args.whatshap,
                           longphase=args.longphase)
        return True
    if args.command == "get_rna_bed":
        from clair3_rna_torch.evaluation.rna_bed import build_rna_bed
        build_rna_bed(args.bam_fn, args.output_fn,
                      min_coverage=args.min_coverage,
                      high_conf_bed_fn=args.high_conf_bed_fn)
        return True
    if args.command == "cal_truth_vcf_af_distribution":
        from clair3_rna_torch.evaluation.af_distribution import (
            truth_site_support, write_truths_file)
        contigs = args.ctg_name.split(",") if args.ctg_name else None
        records = truth_site_support(args.bam_fn, args.ref_fn,
                                     args.truth_vcf_fn, contigs=contigs,
                                     with_hp=args.with_hp, device=args.device)
        write_truths_file(records, args.output_fn)
        print(f"[INFO] wrote truth support -> {args.output_fn}")
        return True
    if args.command == "cal_af_distribution":
        from clair3_rna_torch.evaluation.af_distribution import (
            paired_site_support, write_paired_file)
        if not args.normal_bam_fn and not args.tumor_bam_fn:
            raise SystemExit("[ERROR] cal_af_distribution: provide "
                             "--normal_bam_fn and/or --tumor_bam_fn")
        contigs = args.ctg_name.split(",") if args.ctg_name else None
        records = paired_site_support(args.normal_bam_fn, args.tumor_bam_fn,
                                      args.ref_fn, args.truth_vcf_fn,
                                      contigs=contigs, device=args.device)
        write_paired_file(records, args.output_fn)
        print(f"[INFO] wrote paired support for {len(records)} sites "
              f"-> {args.output_fn}")
        return True
    if args.command == "get_truth_from_af":
        from clair3_rna_torch.evaluation.af_distribution import load_truths_file
        from clair3_rna_torch.evaluation.truth_filter import (
            find_low_confident_variants, write_filtered_truth)
        support = load_truths_file(args.truths_fn)
        kept, dropped = find_low_confident_variants(
            args.truth_vcf_fn, support,
            min_coverage=args.min_coverage,
            min_alt_coverage=args.min_alt_coverage,
            hom_min_af=args.hom_min_af, het_max_af=args.het_max_af)
        write_filtered_truth(args.truth_vcf_fn, kept, args.output_fn)
        print(f"[INFO] kept {len(kept)} truth sites, dropped {len(dropped)} "
              f"-> {args.output_fn}")
        return True
    if args.command == "call_silver_editing_site":
        from clair3_rna_torch.evaluation.silver_editing import (
            find_editing_sites, write_sites)
        from clair3_rna_torch.io.bed import BedRegions
        contigs = args.ctg_name.split(",") if args.ctg_name else None
        dsrna = BedRegions.from_file(args.dsrna_bed_fn) \
            if args.dsrna_bed_fn else None
        sites = find_editing_sites(
            args.bam_fn, args.ref_fn, dna_bam_path=args.dna_bam_fn,
            contigs=contigs, rna_min_af=args.rna_min_af,
            dsrna_min_af=args.dsrna_min_af, dsrna_regions=dsrna,
            dna_max_af=args.dna_max_af, dna_min_depth=args.dna_min_depth,
            min_coverage=args.min_coverage, device=args.device)
        write_sites(sites, args.output_fn)
        print(f"[INFO] {len(sites)} silver editing sites -> {args.output_fn}")
        return True
    if args.command == "calculate_overall_metrics":
        from clair3_rna_torch.evaluation.af_distribution import load_truths_file
        support = load_truths_file(args.truths_fn) if args.truths_fn else None
        if args.happy_vcf_fn:
            from clair3_rna_torch.evaluation.overall_metrics import (
                best_f1_sweep, format_happy_table, happy_metrics)
            counts, sweep_inputs = happy_metrics(
                args.happy_vcf_fn, ctg_name=args.ctg_name,
                truths_support=support, input_vcf_fn=args.vcf_fn,
                input_filter_tag=args.input_filter_tag,
                min_qual=args.min_qual, min_coverage=args.min_coverage,
                min_alt_coverage=args.min_alt_coverage, min_af=args.min_af,
                skip_genotyping=args.skip_genotyping)
            sweep = best_f1_sweep(*sweep_inputs) \
                if args.output_best_f1_score else None
            table = format_happy_table(counts, sweep)
            if args.output_fn:
                with open(args.output_fn, "w") as f:
                    f.write(table + "\n")
            print(table)
            return True
        from clair3_rna_torch.evaluation.overall_metrics import (
            print_table, stratified_metrics)
        if not args.vcf_fn or not args.truth_vcf_fn:
            raise SystemExit("--vcf_fn and --truth_vcf_fn required "
                             "(or pass --happy_vcf_fn)")
        results = stratified_metrics(
            args.vcf_fn, args.truth_vcf_fn, truths_support=support,
            bed_fn=args.bed_fn, ctg_name=args.ctg_name,
            min_coverage=args.min_coverage,
            min_alt_coverage=args.min_alt_coverage, min_af=args.min_af,
            skip_genotyping=args.skip_genotyping)
        print_table(results)
        return True
    if args.command == "add_back_missing_variants_in_genotyping":
        from clair3_rna_torch.postprocess.genotyping import (
            add_back_missing_variants)
        _, n_added = add_back_missing_variants(
            args.vcf_fn, args.sites_vcf_fn, args.bam_fn, args.ref_fn,
            args.output_fn, device=args.device)
        print(f"[INFO] added back {n_added} missing sites -> {args.output_fn}")
        return True
    if args.command == "concat_files":
        from clair3_rna_torch.postprocess.concat import concat_files
        concat_files(args.input_dir, args.output_fn, prefix=args.prefix,
                     suffix=args.suffix,
                     skip_header_after_first=not args.keep_all_headers)
        print(f"[INFO] concatenated -> {args.output_fn}")
        return True
    return False
