"""Per-truth-site coverage / allele-support extraction.

Capability match for src/cal_truth_vcf_af_distribution.py (and the
tumor/normal variant src/cal_af_distribution.py): for every truth variant,
report read depth and per-allele supporting read counts (optionally split by
HP tag) so benchmarking can stratify by coverage/AF. Uses our pileup feature
builder instead of streaming mpileup text; `device` is where the builder
takes its channel counts under CLAIR3_RNA_TORCH_PILEUP_BACKEND=device|kernel
(the host backend touches no device).
"""

import numpy as np

from clair3_rna_torch.config import PileupConfig
from clair3_rna_torch.io.fasta import FastaFile
from clair3_rna_torch.io.vcf import VcfReader
from clair3_rna_torch.pileup import builder
from clair3_rna_torch.pileup.chunk import extract_region_events, open_bam, ref_codes_from

_BASES = "ACGT"


def truth_site_support(bam_path, ref_path, truth_vcf_path, *, contigs=None,
                       cfg: PileupConfig | None = None, window=2000,
                       with_hp=False, device=None):
    """Yield (ctg, pos1, coverage, [alt_support...], hp_counts) per truth site."""
    cfg = cfg or PileupConfig()
    bam = open_bam(bam_path)
    fasta = FastaFile(ref_path)
    truth = VcfReader(truth_vcf_path)
    by_contig = {}
    for (ctg, pos), rec in truth.variant_dict.items():
        by_contig.setdefault(ctg, []).append((pos, rec))
    out = []
    for ctg, sites in sorted(by_contig.items()):
        if contigs and ctg not in contigs:
            continue
        if ctg not in getattr(bam, "ref_index", {}):
            continue
        sites.sort()
        contig_len = fasta.contig_length(ctg)
        # process in windows around site clusters
        i = 0
        while i < len(sites):
            lo = max(0, sites[i][0] - 1 - 60)
            hi = min(contig_len, sites[i][0] + window)
            group = []
            while i < len(sites) and sites[i][0] <= hi - 60:
                group.append(sites[i])
                i += 1
            hi = min(contig_len, group[-1][0] + 60)
            events = extract_region_events(bam, ctg, lo, hi, cfg)
            ref_seq = fasta.fetch(ctg, lo, hi)
            feat = builder.build_tile_features(events, ref_codes_from(ref_seq),
                                               cfg, device=device)
            indels = builder.SparseIndels.from_events(events)
            for pos1, rec in group:
                p = pos1 - 1 - lo
                if not (0 <= p < hi - lo):
                    continue
                cov = int(feat.depth[p])
                alt_supports = []
                for alt in rec.alt.split(","):
                    alt_supports.append(_allele_support(
                        rec.ref, alt, p, feat, indels, pos1 - 1))
                if with_hp:
                    # per-haplotype coverage breakdown [HP1, HP2, untagged]
                    # (src/cal_truth_vcf_af_distribution.py:49-82)
                    sel = events.base_pos == (pos1 - 1)
                    hps = events.base_hp[sel]
                    hp_counts = [int((hps == 1).sum()), int((hps == 2).sum()),
                                 int((hps == 0).sum())]
                    out.append((ctg, pos1, cov, alt_supports, hp_counts))
                else:
                    out.append((ctg, pos1, cov, alt_supports))
    return out


def _allele_support(ref, alt, p, feat, indels, abs_pos):
    if len(ref) == 1 and len(alt) == 1 and alt in _BASES:
        return int(feat.group_count[p, _BASES.index(alt)])
    if len(alt) > len(ref):  # insertion
        want = alt[len(ref):].upper()
        sel = (indels.ins_pos == abs_pos)
        count = 0
        for j in np.nonzero(sel)[0]:
            if indels.ins_seqs[indels.ins_allele[j]] == want:
                count += 1
        return count
    # deletion
    dlen = len(ref) - len(alt)
    sel = (indels.del_pos == abs_pos) & (indels.del_len == dlen)
    return int(sel.sum())


def paired_site_support(normal_bam_path, tumor_bam_path, ref_path,
                        truth_vcf_path, *, contigs=None,
                        cfg: PileupConfig | None = None, device=None):
    """Tumor/normal per-truth-site support (src/cal_af_distribution.py:160-240
    capability): (ctg, pos, normal_depth, tumor_depth, normal_alt_depth,
    tumor_alt_depth) rows; either BAM may be None (depths report 0)."""
    def as_map(bam_path):
        if bam_path is None:
            return {}
        return {(ctg, pos): (cov, alts)
                for ctg, pos, cov, alts in truth_site_support(
                    bam_path, ref_path, truth_vcf_path, contigs=contigs,
                    cfg=cfg, device=device)}

    normal = as_map(normal_bam_path)
    tumor = as_map(tumor_bam_path)
    out = []
    for key in sorted(set(normal) | set(tumor)):
        n_cov, n_alts = normal.get(key, (0, [0]))
        t_cov, t_alts = tumor.get(key, (0, [0]))
        out.append((key[0], key[1], n_cov, t_cov,
                    max(n_alts) if n_alts else 0,
                    max(t_alts) if t_alts else 0))
    return out


def write_paired_file(records, output_fn):
    """'ctg pos normal_depth tumor_depth normal_alt tumor_alt' rows."""
    with open(output_fn, "w") as f:
        for row in records:
            f.write(" ".join(str(x) for x in row) + "\n")
    return output_fn


def write_truths_file(records, output_fn):
    """'ctg pos cov alt_cov1[,alt_cov2] [hp1,hp2,hp0]' rows (the reference
    'truths' format; the HP triple appears only with with_hp)."""
    with open(output_fn, "w") as f:
        for rec in records:
            ctg, pos, cov, alt_supports = rec[:4]
            row = f"{ctg} {pos} {cov} {','.join(str(s) for s in alt_supports)}"
            if len(rec) > 4:
                row += " " + ",".join(str(c) for c in rec[4])
            f.write(row + "\n")
    return output_fn


def load_truths_file(path):
    out = {}
    with open(path) as f:
        for row in f:
            cols = row.split()
            if len(cols) < 4:
                continue
            cov = float(cols[2])
            alts = [float(x) for x in cols[3].split(",")]
            afs = [a / cov if cov > 0 else 0.0 for a in alts]
            out[(cols[0], int(cols[1]))] = (cov, alts, afs)
    return out
