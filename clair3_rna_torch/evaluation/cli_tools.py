"""CLI subcommands for the evaluation toolkit: so far `phase_bam`, the
stand-alone entry point of the phasing pass."""


def add_tool_parsers(subparsers):
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


def dispatch_tool(args) -> bool:
    """Run the tool subcommand `args.command`; False if it is not one."""
    if args.command == "phase_bam":
        from clair3_rna_torch.phasing.pipeline import phase_and_haplotag
        contigs = args.ctg_name.split(",") if args.ctg_name else None
        phase_and_haplotag(args.bam_fn, args.ref_fn, args.vcf_fn,
                           args.output_bam_fn, contigs=contigs,
                           phaser=args.phaser, whatshap=args.whatshap,
                           longphase=args.longphase)
        return True
    return False
