"""VCF reading/writing + canonical header (mirrors shared/vcf.py and
shared/utils.py:261-316)."""

import gzip
import os
from dataclasses import dataclass, field

from clair3_rna_torch import config
from clair3_rna_torch.io.bgzf import bgzf_compress

VCF_HEADER_TEMPLATE = """\
##fileformat=VCFv4.2
##source=Clair3-RNA
##clair3_rna_version={version}
##FILTER=<ID=PASS,Description="All filters passed">
##FILTER=<ID=LowQual,Description="Low quality variant">
##FILTER=<ID=RefCall,Description="Reference call">
##FILTER=<ID=RNAEditing,Description="RNA editing site tagged by REDIportal dataset">
##INFO=<ID=A,Number=0,Type=Flag,Description="RNA editing site from ATLAS dataset in REDIportal">
##INFO=<ID=R,Number=0,Type=Flag,Description="RNA editing site from RADAR dataset in REDIportal">
##INFO=<ID=D,Number=0,Type=Flag,Description="RNA editing site from DARNED dataset in REDIportal">
##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">
##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype Quality">
##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Approximate read depth (reads with MQ<5 or selected by 'samtools view -F 2316' are filtered)">
##FORMAT=<ID=AD,Number=R,Type=Integer,Description="Allelic depths for the ref and alt alleles in the order listed">
##FORMAT=<ID=AF,Number=1,Type=Float,Description="Observed allele frequency in reads, for each ALT allele, in the same order as listed, or the REF allele for a RefCall">
"""


def vcf_header(reference_file_path=None, cmd_line=None, sample_name="SAMPLE",
               version=config.REFERENCE_VERSION) -> str:
    """Canonical VCF header (shared/utils.py:261-316 semantics)."""
    header = VCF_HEADER_TEMPLATE.format(version=version)
    extra = []
    if reference_file_path is not None and os.path.exists(reference_file_path):
        extra.append(f"##reference={reference_file_path}")
    if cmd_line:
        extra.append(f"##cmdline={cmd_line}")
    for line in extra:
        header_list = header.rstrip("\n").split("\n")
        insert_index = 3 if len(header_list) >= 3 else len(header_list) - 1
        header_list.insert(insert_index, line)
        header = "\n".join(header_list) + "\n"
    if reference_file_path is not None:
        fai = reference_file_path + ".fai"
        if not os.path.exists(fai):
            base, _, _ = reference_file_path.rpartition(".")
            if base and os.path.exists(base + ".fai"):
                fai = base + ".fai"
        with open(fai) as f:
            for row in f:
                cols = row.strip().split("\t")
                header += f"##contig=<ID={cols[0]},length={cols[1]}>\n"
        header += ("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t%s"
                   % sample_name)
    return header


@dataclass
class VcfRecord:
    ctg_name: str
    pos: int
    ref: str
    alt: str
    qual: float | None = None
    filter: str = "."
    info: str = "."
    genotype: tuple = (0, 0)
    format_fields: dict = field(default_factory=dict)
    raw: str = ""


def _open_text(path):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path)


class VcfReader:
    """Parse a (possibly gzipped) VCF into records, optionally by contig."""

    def __init__(self, vcf_fn, ctg_name=None, keep_row_str=False,
                 show_ref=True, min_qual=None):
        self.variant_dict = {}
        self.header_lines = []
        if vcf_fn is None or not os.path.exists(vcf_fn):
            return
        with _open_text(vcf_fn) as f:
            for row in f:
                if row.startswith("#"):
                    self.header_lines.append(row)
                    continue
                cols = row.rstrip("\n").split("\t")
                ctg = cols[0]
                if ctg_name is not None and ctg != ctg_name:
                    continue
                pos = int(cols[1])
                ref, alt = cols[3], cols[4]
                try:
                    qual = float(cols[5])
                except ValueError:
                    qual = None
                if min_qual is not None and (qual is None or qual < min_qual):
                    continue
                is_ref_call = alt == "." or ref == alt
                if not show_ref and is_ref_call:
                    continue
                genotype = (0, 0)
                if len(cols) > 9:
                    gt_str = cols[9].split(":")[0].replace("|", "/")
                    parts = gt_str.split("/")
                    try:
                        genotype = tuple(int(p) if p != "." else -1 for p in parts)
                    except ValueError:
                        genotype = (-1, -1)
                self.variant_dict[(ctg, pos)] = VcfRecord(
                    ctg_name=ctg, pos=pos, ref=ref, alt=alt, qual=qual,
                    filter=cols[6] if len(cols) > 6 else ".",
                    info=cols[7] if len(cols) > 7 else ".",
                    genotype=genotype,
                    raw=row if keep_row_str else "")

    def positions(self, ctg_name=None):
        return sorted(pos for (ctg, pos) in self.variant_dict
                      if ctg_name is None or ctg == ctg_name)


class VcfWriter:
    def __init__(self, vcf_fn, reference_file_path=None, sample_name="SAMPLE",
                 cmd_line=None, write_header=True):
        self.vcf_fn = vcf_fn
        self._fp = open(vcf_fn, "w")
        if write_header:
            header = vcf_header(reference_file_path, cmd_line, sample_name)
            self._fp.write(header.rstrip("\n") + "\n")

    def write_row(self, row: str):
        self._fp.write(row)
        if not row.endswith("\n"):
            self._fp.write("\n")

    def close(self):
        self._fp.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def compress_index_vcf(vcf_path: str) -> str:
    """bgzip-compress a VCF in place (-> .gz) and build a .tbi tabix index."""
    with open(vcf_path, "rb") as f:
        data = f.read()
    gz_path = vcf_path + ".gz"
    with open(gz_path, "wb") as f:
        f.write(bgzf_compress(data))
    os.remove(vcf_path)
    try:
        from clair3_rna_torch.io.tabix import build_tabix_index
        build_tabix_index(gz_path)
    except Exception:
        pass  # index is best-effort convenience
    return gz_path
