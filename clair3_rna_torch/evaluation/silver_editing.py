"""Silver-standard RNA-editing site discovery.

Capability match for src/call_silver_editing_site.py:95-201: scan RNA pileups
for A->G (fwd) / T->C (rev) substitutions with high RNA AF (>0.75, or >0.4
inside double-stranded-RNA regions) that are absent from DNA (DNA AF <= 0.25
at depth >= 8) -- such sites are ADAR editing, used as training negatives.
`device` is where the pileup builder takes its channel counts under
CLAIR3_RNA_TORCH_PILEUP_BACKEND=device|kernel."""

import numpy as np

from clair3_rna_torch.config import PileupConfig
from clair3_rna_torch.io.fasta import FastaFile
from clair3_rna_torch.pileup import builder
from clair3_rna_torch.pileup.chunk import (extract_region_events, open_bam,
                                           plan_chunks, ref_codes_from)

_BASES = "ACGT"
A, C, G, T = range(4)


def find_editing_sites(rna_bam_path, ref_path, *, dna_bam_path=None,
                       contigs=None, cfg: PileupConfig | None = None,
                       rna_min_af=0.75, dsrna_min_af=0.4, dsrna_regions=None,
                       dna_max_af=0.25, dna_min_depth=8, min_coverage=4,
                       chunk_size=1_000_000, device=None):
    """Return [(ctg, pos1, ref, alt, rna_af)] candidate editing sites."""
    cfg = cfg or PileupConfig()
    rna = open_bam(rna_bam_path)
    dna = open_bam(dna_bam_path) if dna_bam_path else None
    fasta = FastaFile(ref_path)
    sites = []
    for task in plan_chunks(fasta, contigs=contigs, chunk_size=chunk_size):
        ref_seq = fasta.fetch(task.ctg_name, task.start, task.end)
        codes = ref_codes_from(ref_seq)
        events = extract_region_events(rna, task.ctg_name, task.start, task.end, cfg)
        feat = builder.build_tile_features(events, codes, cfg, device=device)
        denom = np.maximum(feat.depth, 1).astype(np.float64)
        # A>G on the forward-annotated strand, T>C on the reverse
        for ref_code, alt_code in ((A, G), (T, C)):
            is_ref = feat.ref_code == ref_code
            alt_af = feat.group_count[:, alt_code] / denom
            min_af = np.full(len(alt_af), rna_min_af)
            if dsrna_regions is not None:
                in_ds = dsrna_regions.mask_for_range(task.ctg_name, task.start,
                                                     task.end)
                min_af = np.where(in_ds, dsrna_min_af, min_af)
            mask = (is_ref & feat.covered & (feat.depth >= min_coverage)
                    & (alt_af >= min_af))
            for i in np.nonzero(mask)[0]:
                pos1 = task.start + i + 1
                if dna is not None and not _dna_clear(
                        dna, fasta, task.ctg_name, pos1, alt_code, cfg,
                        dna_max_af, dna_min_depth, device):
                    continue
                sites.append((task.ctg_name, pos1, _BASES[ref_code],
                              _BASES[alt_code], float(alt_af[i])))
    return sites


def _dna_clear(dna, fasta, ctg, pos1, alt_code, cfg, dna_max_af, dna_min_depth,
               device=None):
    lo, hi = pos1 - 1, pos1
    events = extract_region_events(dna, ctg, lo, hi, cfg)
    ref_seq = fasta.fetch(ctg, lo, hi)
    feat = builder.build_tile_features(events, ref_codes_from(ref_seq), cfg,
                                       device=device)
    depth = int(feat.depth[0])
    if depth < dna_min_depth:
        return False
    af = feat.group_count[0, alt_code] / max(1, depth)
    return af <= dna_max_af


def write_sites(sites, output_fn):
    with open(output_fn, "w") as f:
        for ctg, pos, ref, alt, af in sites:
            f.write(f"{ctg}\t{pos}\t{ref}\t{alt}\t{af:.4f}\n")
    return output_fn
