"""Genotype label spaces: GT21 pairs, zygosity, variant length.

A frozen copy of the program's clair3_rna_torch/task.py (the parts the
reference decoder and trainer use). Its own description follows.

Semantics match the reference task package (clair3_rna/task/gt21.py:29-115,
genotype.py:6-33, variant_length.py:6-12, main.py:10-48) -- these enums define
the network output layout and must agree bit-for-bit for checkpoint
compatibility and VCF parity.
"""

from collections import namedtuple
from enum import IntEnum

GT21_LABELS = (
    "AA", "AC", "AG", "AT", "CC", "CG", "CT", "GG", "GT", "TT",
    "DelDel", "ADel", "CDel", "GDel", "TDel",
    "InsIns", "AIns", "CIns", "GIns", "TIns",
    "InsDel",
)
GT21_LABEL_INDEX = {label: i for i, label in enumerate(GT21_LABELS)}


class GT21(IntEnum):
    AA = 0
    AC = 1
    AG = 2
    AT = 3
    CC = 4
    CG = 5
    CT = 6
    GG = 7
    GT = 8
    TT = 9
    DelDel = 10
    ADel = 11
    CDel = 12
    GDel = 13
    TDel = 14
    InsIns = 15
    AIns = 16
    CIns = 17
    GIns = 18
    TIns = 19
    InsDel = 20


HOMO_SNP_GT21 = (GT21.AA, GT21.CC, GT21.GG, GT21.TT)
HOMO_SNP_LABELS = tuple(GT21_LABELS[g] for g in HOMO_SNP_GT21)
HETERO_SNP_GT21 = (GT21.AC, GT21.AG, GT21.AT, GT21.CG, GT21.CT, GT21.GT)
HETERO_SNP_LABELS = tuple(GT21_LABELS[g] for g in HETERO_SNP_GT21)


def gt21_from_label(label: str) -> int:
    return GT21_LABEL_INDEX[label]


def partial_label(ref: str, alt: str) -> str:
    """One haplotype's contribution to a GT21 label: a base, 'Ins', or 'Del'."""
    if len(ref) > len(alt):
        return "Del"
    if len(ref) < len(alt):
        return "Ins"
    return alt[0]


def mix_partial_labels(label1: str, label2: str) -> str:
    """Combine two haplotype partial labels into a canonical GT21 label."""
    if len(label1) == 1 and len(label2) == 1:
        return label1 + label2 if label1 <= label2 else label2 + label1
    a, b = (label2, label1) if (len(label1) > 1 and len(label2) == 1) else (label1, label2)
    if len(b) > 1 and len(a) == 1:
        return a + b
    if label1 and label2 and label1 == label2:
        return label1 + label2
    return GT21_LABELS[GT21.InsDel]


def gt21_enum_from(reference, alternate, genotype_1, genotype_2, alternate_arr=None):
    if alternate_arr is None:
        alternate_arr = alternate.split(",")
        if len(alternate_arr) == 1:
            alternate_arr = [
                reference if genotype_1 == 0 or genotype_2 == 0 else alternate_arr[0]
            ] + alternate_arr
    partials = [partial_label(reference, alt) for alt in alternate_arr]
    return gt21_from_label(mix_partial_labels(partials[0], partials[1]))


GENOTYPE_STRINGS = ("0/0", "1/1", "0/1", "1/2")


class Genotype(IntEnum):
    homo_reference = 0       # 0/0
    homo_variant = 1         # 1/1
    hetero_variant = 2       # 0/1 (also 1/2 in the 3-class task)
    hetero_variant_multi = 3  # 1/2


def genotype_string(genotype_enum) -> str:
    try:
        return GENOTYPE_STRINGS[genotype_enum]
    except (IndexError, TypeError):
        return ""


def genotype_enum_from(genotype_1: int, genotype_2: int) -> Genotype:
    if genotype_1 == 0 and genotype_2 == 0:
        return Genotype.homo_reference
    if genotype_1 == genotype_2:
        return Genotype.homo_variant
    if genotype_1 != 0 and genotype_2 != 0:
        return Genotype.hetero_variant_multi
    return Genotype.hetero_variant


def genotype_enum_for_task(genotype: Genotype) -> Genotype:
    """Collapse 1/2 into the het class for the 3-way zygosity head."""
    if genotype == Genotype.hetero_variant_multi:
        return Genotype.hetero_variant
    return genotype


VariantLengthSpace = namedtuple(
    "VariantLengthSpace", ["index_offset", "min", "max", "output_label_count"]
)
VARIANT_LENGTH = VariantLengthSpace(
    index_offset=16, min=-16, max=16, output_label_count=33
)
