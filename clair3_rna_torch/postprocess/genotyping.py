"""Genotyping-mode add-back: re-insert truth sites missing from the output.

Capability match for src/add_back_missing_variants_in_genotyping.py:152-290:
in --vcf_fn genotyping mode every requested site must appear in the output;
sites the caller produced nothing for are added back as ./. rows with their
observed ACGT depths (from the pileup builder, whose channel counts are
taken on `device` under CLAIR3_RNA_TORCH_PILEUP_BACKEND=device|kernel)."""

from clair3_rna_torch.config import PileupConfig
from clair3_rna_torch.io.fasta import FastaFile
from clair3_rna_torch.io.vcf import VcfReader
from clair3_rna_torch.pileup import builder
from clair3_rna_torch.pileup.chunk import extract_region_events, open_bam, ref_codes_from

_BASES = "ACGT"


def add_back_missing_variants(call_vcf_fn, sites_vcf_fn, bam_path, ref_path,
                              output_fn, *, cfg: PileupConfig | None = None,
                              device=None):
    """Write output_fn = call VCF + ./. rows for requested sites not called."""
    cfg = cfg or PileupConfig()
    calls = VcfReader(call_vcf_fn, keep_row_str=True)
    sites = VcfReader(sites_vcf_fn)
    missing = [key for key in sites.variant_dict if key not in calls.variant_dict]

    bam = open_bam(bam_path)
    fasta = FastaFile(ref_path)
    added_rows = []
    for ctg, pos1 in sorted(missing):
        if ctg not in getattr(bam, "ref_index", {}):
            continue
        rec = sites.variant_dict[(ctg, pos1)]
        lo, hi = max(0, pos1 - 1), pos1
        events = extract_region_events(bam, ctg, lo, hi, cfg)
        ref_seq = fasta.fetch(ctg, lo, hi)
        feat = builder.build_tile_features(events, ref_codes_from(ref_seq), cfg,
                                           device=device)
        depth = int(feat.depth[0])
        acgt = ",".join(str(int(feat.group_count[0, i])) for i in range(4))
        added_rows.append(
            f"{ctg}\t{pos1}\t.\t{rec.ref}\t{rec.alt}\t0.00\t.\t"
            f"ACGT_counts={acgt}\tGT:GQ:DP:AD:AF\t./.:0:{depth}:0:0.0000")

    header_done = False
    with open(output_fn, "w") as out:
        body = []
        for line in open(call_vcf_fn):
            if line.startswith("#"):
                out.write(line)
                header_done = True
            else:
                body.append(line.rstrip("\n"))
        body.extend(added_rows)

        def sort_key(row):
            cols = row.split("\t", 2)
            return (cols[0], int(cols[1]))
        for row in sorted(body, key=sort_key):
            out.write(row + "\n")
    return output_fn, len(added_rows)
