"""Training-truth curation: drop truth variants with no/low read support or
zygosity-AF mismatch (capability match for src/get_truth_from_af.py:45-146,
which is broken in the reference -- it imports a nonexistent module)."""

from clair3_rna_torch.io.vcf import VcfReader


def find_low_confident_variants(truth_vcf_fn, truths_support, *,
                                min_coverage=4, min_alt_coverage=2,
                                hom_min_af=0.2, het_max_af=0.8):
    """Return (kept, dropped) truth site keys.

    Rules from the reference: drop sites with insufficient coverage or alt
    support; drop homozygous truths whose observed AF < hom_min_af and
    heterozygous truths whose observed AF > het_max_af (likely mislabeled
    zygosity in RNA)."""
    truth = VcfReader(truth_vcf_fn)
    kept, dropped = [], []
    for (ctg, pos), rec in sorted(truth.variant_dict.items()):
        info = truths_support.get((ctg, pos))
        if info is None:
            dropped.append((ctg, pos, "no-support-info"))
            continue
        cov, alts, afs = info
        af = max(afs, default=0.0)
        alt_cov = max(alts, default=0)
        if cov < min_coverage:
            dropped.append((ctg, pos, "low-coverage"))
        elif alt_cov < min_alt_coverage:
            dropped.append((ctg, pos, "low-alt-support"))
        elif sorted(rec.genotype) == [1, 1] and af < hom_min_af:
            dropped.append((ctg, pos, "hom-low-af"))
        elif sorted(rec.genotype) == [0, 1] and af > het_max_af:
            dropped.append((ctg, pos, "het-high-af"))
        else:
            kept.append((ctg, pos))
    return kept, dropped


def write_filtered_truth(truth_vcf_fn, kept, output_fn):
    kept_set = set(kept)
    with open(output_fn, "w") as out:
        for line in open(truth_vcf_fn):
            if line.startswith("#"):
                out.write(line)
                continue
            cols = line.split("\t", 2)
            if (cols[0], int(cols[1])) in kept_set:
                out.write(line)
    return output_fn
