"""CLI subcommands for training: tensor2bin and train."""

_DEVICE_HELP = ("device for the network (train) or for the pure-array "
                "builder's counts under CLAIR3_RNA_TORCH_PILEUP_BACKEND="
                "device|kernel (tensor2bin); without CUDA the run fails "
                "unless 'cpu' is given")


def add_train_parsers(subparsers):
    b = subparsers.add_parser("tensor2bin",
                              help="build training bins from BAM + truth VCF")
    b.add_argument("--bam_fn", required=True)
    b.add_argument("--ref_fn", required=True)
    b.add_argument("--truth_vcf_fn", required=True)
    b.add_argument("--output_dir", required=True)
    b.add_argument("--ctg_name", default=None)
    b.add_argument("--platform", default="ont_dorado_drna004")
    b.add_argument("--non_variant_keep_fraction", type=float, default=0.1)
    b.add_argument("--shard_size", type=int, default=20000)
    b.add_argument("--phased", action="store_true",
                   help="30-channel tensors from an HP-haplotagged BAM "
                        "(phasing-model training)")
    b.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help=_DEVICE_HELP)

    t = subparsers.add_parser("train", help="train the pileup network")
    t.add_argument("--bin_dir", required=True)
    t.add_argument("--output_fn", required=True, help=".npz weights output")
    t.add_argument("--batch_size", type=int, default=2000)
    t.add_argument("--learning_rate", type=float, default=1e-3)
    t.add_argument("--max_epochs", type=int, default=30)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--no_indel_length", action="store_true")
    t.add_argument("--phased", action="store_true",
                   help="train the 30-channel phasing model")
    t.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help=_DEVICE_HELP)


def dispatch_train(args) -> bool:
    if args.command == "tensor2bin":
        from clair3_rna_torch import resolve_device
        from clair3_rna_torch.config import PileupConfig
        from clair3_rna_torch.train.data import build_training_bins
        cfg = PileupConfig.for_platform(args.platform, phased=args.phased)
        contigs = args.ctg_name.split(",") if args.ctg_name else None
        build_training_bins(args.bam_fn, args.ref_fn, args.truth_vcf_fn,
                            args.output_dir, cfg=cfg, contigs=contigs,
                            non_variant_keep_fraction=args.non_variant_keep_fraction,
                            shard_size=args.shard_size,
                            device=resolve_device(args.device))
        return True
    if args.command == "train":
        from clair3_rna_torch.train.train import train_model
        train_model(args.bin_dir, args.output_fn,
                    add_indel_length=not args.no_indel_length,
                    phased=args.phased,
                    batch_size=args.batch_size,
                    learning_rate=args.learning_rate,
                    max_epochs=args.max_epochs, seed=args.seed,
                    device=args.device)
        return True
    return False
