"""Merge per-chunk VCF rows into one sorted, tagged output VCF.

Behavioral port of src/sort_vcf.py:123-292: contig-major order (chr1..chrY
first), positions deduplicated last-writer-wins, RefCall rows dropped unless
show_ref, LowQual marking at qual <= cutoff, REDIportal RNA-editing tagging
with an untagged twin output, and native bgzip+tabix. The mechanism differs:
rows stream from in-memory per-chunk results (or files) instead of a shell
pipeline.
"""

import gzip
import os
from collections import defaultdict

from clair3_rna_torch.config import REDIPORTAL_FILTER_TAGS
from clair3_rna_torch.io.vcf import compress_index_vcf, vcf_header

MAJOR_CONTIGS_ORDER = ["chr" + str(a) for a in list(range(1, 23)) + ["X", "Y"]] + \
    [str(a) for a in list(range(1, 23)) + ["X", "Y"]]


def mark_low_qual(row: str, quality_score_for_pass, qual: float) -> str:
    if row == "":
        return row
    if quality_score_for_pass and qual <= quality_score_for_pass:
        cols = row.split("\t")
        cols[6] = "LowQual"
        return "\t".join(cols)
    return row


def mark_rediportal(row: str, item):
    tagged = False
    if row == "" or "Germline" in row or "RefCall" in row:
        return row, tagged
    red_ref, red_alt = item[:2]
    cols = row.split("\t", maxsplit=8)
    if red_ref == cols[3] and red_alt == cols[4]:
        cols[6] = "RNAEditing"
        tagged = True
    return "\t".join(cols), tagged


def load_rediportal(path, contigs=None, filter_tags=REDIPORTAL_FILTER_TAGS):
    """REDIportal table -> {(ctg, pos): (ref, alt, db)} (src/sort_vcf.py:175-206)."""
    out = {}
    if path is None or not os.path.exists(path):
        return out
    allowed = set(filter_tags.split(":")) if filter_tags is not None else None
    opener = gzip.open if path.endswith(".gz") else open
    contigs = set(contigs) if contigs else None
    with opener(path, "rt") as f:
        for row_idx, row in enumerate(f):
            if row_idx == 0:
                continue
            cols = row.rstrip().split("\t", maxsplit=6)
            if contigs and cols[0] not in contigs:
                continue
            try:
                key = (cols[0], int(cols[1]))
            except (ValueError, IndexError):
                continue
            db_filter = cols[5]
            if allowed is not None and db_filter not in allowed:
                continue
            out[key] = (cols[2], cols[3], db_filter)
    return out


def contig_sort_order(contigs):
    order = MAJOR_CONTIGS_ORDER + list(contigs)
    return sorted(contigs, key=lambda x: order.index(x))


def sort_rows(rows_by_contig: dict, output_fn: str, *, show_ref=False,
              qual_cutoff=None, rediportal=None, output_no_tagging_fn=None,
              reference_file_path=None, sample_name="SAMPLE", cmd_line=None,
              compress=True):
    """Merge {contig: iterable of VCF row strings} -> sorted output VCF(s).

    Rows may arrive from multiple chunks; duplicates at one position keep the
    last row seen (matching the reference's dict overwrite behavior).
    """
    rediportal = rediportal or {}
    tag_enabled = output_no_tagging_fn is not None
    header = vcf_header(reference_file_path, cmd_line, sample_name)

    out = open(output_fn, "w")
    out.write(header.rstrip("\n") + "\n")
    out_untagged = None
    if tag_enabled:
        out_untagged = open(output_no_tagging_fn, "w")
        out_untagged.write(header.rstrip("\n") + "\n")

    n_tagged = 0
    n_rows = 0
    for contig in contig_sort_order(list(rows_by_contig.keys())):
        contig_dict = defaultdict(str)
        for row in rows_by_contig[contig]:
            row = row.rstrip("\n")
            if not row or row[0] == "#":
                continue
            cols = row.split(maxsplit=6)
            pos = int(cols[1])
            qual = float(cols[5])
            ref_base, alt_base = cols[3], cols[4]
            is_reference = alt_base == "." or ref_base == alt_base
            if not show_ref and is_reference:
                continue
            if not is_reference:
                row = mark_low_qual(row, qual_cutoff, qual)
            key = (contig, pos)
            if key in rediportal:
                row, tagged = mark_rediportal(row, rediportal[key])
                n_tagged += int(tagged)
            contig_dict[pos] = row
        for pos in sorted(contig_dict):
            out.write(contig_dict[pos] + "\n")
            n_rows += 1
            if tag_enabled:
                out_untagged.write(contig_dict[pos].replace("RNAEditing", "PASS") + "\n")

    out.close()
    if out_untagged:
        out_untagged.close()

    outputs = [output_fn] + ([output_no_tagging_fn] if tag_enabled else [])
    if compress:
        outputs = [compress_index_vcf(p) for p in outputs]
    return outputs, n_rows, n_tagged


def sort_vcf_files(input_dir, output_fn, contigs, vcf_fn_prefix="pileup_", **kwargs):
    """File-based variant mirroring the reference CLI (per-chunk VCF files)."""
    rows_by_contig = {}
    all_files = sorted(os.listdir(input_dir)) if os.path.isdir(input_dir) else []
    for contig in contigs:
        rows = []
        for fn in all_files:
            if not fn.startswith(vcf_fn_prefix):
                continue
            if contig not in fn:
                continue
            with open(os.path.join(input_dir, fn)) as f:
                for row in f:
                    if row[0] == "#":
                        continue
                    if row.split(maxsplit=1)[0] != contig:
                        break
                    rows.append(row)
        rows_by_contig[contig] = rows
    return sort_rows(rows_by_contig, output_fn, **kwargs)
