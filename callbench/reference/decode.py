"""Genotype decode: network probabilities + allele counts -> VCF rows.

A frozen copy of the program's decoder (clair3_rna_torch/caller/decode.py),
taken when the benchmark was defined, with its imports made local: the
reference decodes with it so that a later change to the program's decoder
is judged against this one. Its own description follows.

Semantics-exact port of the reference decoder
(clair3_rna/call_variants.py:383-1392): the outcome-probability enumeration,
the argmax-with-fallback loop that zeroes outcomes lacking read evidence, QUAL
computation, AD/AF assembly and the VCF row format all match bit-for-bit on
float32 probabilities. This is intentionally host-side scalar code -- it is
string-heavy, runs on ~1% of sites after the device pre-screen
(caller.prescreen), and exact tie-breaking matters for VCF equality.
"""

import math
from dataclasses import dataclass
from math import e, log

import numpy as np

from callbench.reference import task_config as config
from callbench.reference.task import (
    GT21, Genotype, HOMO_SNP_GT21, HOMO_SNP_LABELS, HETERO_SNP_GT21,
    HETERO_SNP_LABELS, VARIANT_LENGTH, genotype_string, gt21_from_label,
    partial_label, mix_partial_labels, genotype_enum_from, genotype_enum_for_task,
)

ACGT = "ACGT"
PHRED_TRANS = -10 * log(e, 10)
BASE2ACGT = dict(zip(
    "ACGTURYSWKMBDHVN",
    ("A", "C", "G", "T", "T", "A", "C", "C", "A", "G", "A", "C", "A", "A", "A", "A")
))
BASIC_BASES = set("ACGTU")


def convert_iupac_to_n(s: str) -> str:
    if s == ".":
        return s
    out = []
    changed = False
    for ch in s:
        if ch.upper() not in "ACGTN,.":
            out.append("N")
            changed = True
        else:
            out.append(ch)
    return "".join(out) if changed else s


@dataclass
class CallConfig:
    show_ref: bool = False
    qual: float | None = None                 # PASS/LowQual cutoff at caller level
    add_indel_length: bool = False
    gvcf: bool = False
    enable_long_indel: bool = False
    keep_iupac_bases: bool = False
    haploid_precise: bool = False
    haploid_sensitive: bool = False
    debug: bool = False                        # emit raw probability rows
    max_infer_variant_length: int = config.MAX_VARIANT_LENGTH
    # GVCF block construction knobs (clair3_rna/call_var_bam.py --base_err /
    # --gq_bin_size / --bp_resolution)
    gvcf_p_err: float = 0.001
    gvcf_gq_bin_size: int = 5
    gvcf_bp_resolution: bool = False

    @property
    def maximum_variant_length_that_need_infer(self):
        if self.enable_long_indel:
            return config.MAX_VARIANT_LENGTH_LONG_INDEL
        return self.max_infer_variant_length


def quality_score_from(probability) -> float:
    p = probability
    tmp = max(PHRED_TRANS * log(((1.0 - p) + 1e-10) / (p + 1e-10)) + 10, 0)
    return float(round(tmp, 2))


def filtration_value_from(quality_score_for_pass, quality_score, is_reference=False):
    if is_reference:
        return "RefCall"
    if quality_score_for_pass is None:
        return "PASS"
    if quality_score >= quality_score_for_pass:
        return "PASS"
    return "LowQual"


def insertion_bases_from(alt_info_dict, propose_insertion_length=None,
                         minimum_insertion_length=1, maximum_insertion_length=50,
                         insertion_bases_to_ignore="", return_multi=False):
    if propose_insertion_length:
        propose_insertion_length += 1  # include the reference base
    if not len(alt_info_dict):
        return ""
    insertion_bases_dict = {}
    propose_dict = {}
    for raw_key, count in alt_info_dict.items():
        if raw_key[0] != "I":
            continue
        key = raw_key[1:]
        if propose_insertion_length and len(key) == propose_insertion_length \
                and key != insertion_bases_to_ignore:
            propose_dict[key] = count
        elif minimum_insertion_length <= len(key) <= maximum_insertion_length \
                and key != insertion_bases_to_ignore:
            insertion_bases_dict[key] = count
    if propose_insertion_length and len(propose_dict):
        return max(propose_dict, key=propose_dict.get)
    if return_multi:
        ins_list = [item[0] for item in
                    sorted(insertion_bases_dict.items(), key=lambda x: x[1])[::-1]]
        return ins_list[:2] if len(ins_list) else ""
    return max(insertion_bases_dict, key=insertion_bases_dict.get) \
        if len(insertion_bases_dict) > 0 else ""


def deletion_bases_from(alt_info_dict, propose_deletion_length=None,
                        minimum_deletion_length=1, maximum_deletion_length=50,
                        deletion_bases_to_ignore="", return_multi=False):
    if not len(alt_info_dict):
        return ""
    deletion_bases_dict = {}
    propose_dict = {}
    for raw_key, count in alt_info_dict.items():
        if raw_key[0] != "D":
            continue
        key = raw_key[1:]
        if propose_deletion_length and len(key) == propose_deletion_length \
                and key != deletion_bases_to_ignore:
            propose_dict[key] = count
        elif minimum_deletion_length <= len(key) <= maximum_deletion_length \
                and key != deletion_bases_to_ignore:
            deletion_bases_dict[key] = count
    if propose_deletion_length and len(propose_dict):
        return max(propose_dict, key=propose_dict.get)
    if return_multi:
        del_list = [item[0] for item in
                    sorted(deletion_bases_dict.items(), key=lambda x: x[1])[::-1]]
        if len(del_list) <= 1:
            return ""
        return [del_list[0], del_list[1]] if len(del_list[0]) > len(del_list[1]) \
            else [del_list[1], del_list[0]]
    return max(deletion_bases_dict, key=deletion_bases_dict.get) \
        if len(deletion_bases_dict) > 0 else ""


def get_long_indel_read_count(alt_info, proposed_ins_base="",
                              propose_del_base_length=0, is_del=False):
    """Count flanking long-indel signals for AD of >50bp indels
    (clair3_rna/call_variants.py:392-411)."""
    long_indel_read_count = 0
    max_infer = config.MAX_VARIANT_LENGTH
    if len(proposed_ins_base) > max_infer or propose_del_base_length > max_infer:
        propose_len = propose_del_base_length if is_del else len(proposed_ins_base) - 1
        min_len = max(propose_len * (1.0 - config.LONG_INDEL_DISTANCE_PROPORTION), max_infer)
        max_len = propose_len * (1.0 + config.LONG_INDEL_DISTANCE_PROPORTION)
        for alt_base, count in alt_info.items():
            if is_del and len(alt_base) == propose_del_base_length:
                continue
            if alt_base == proposed_ins_base:
                continue
            if min_len <= len(alt_base) <= max_len:
                long_indel_read_count += count
    return long_indel_read_count


def homo_Ins_tuples_from(vl1, vl2, extra):
    off = VARIANT_LENGTH.index_offset
    return [(i, vl1[i + off] * vl2[i + off] * extra)
            for i in range(1, VARIANT_LENGTH.max + 1)]


def hetero_Ins_tuples_from(vl1, vl2):
    off = VARIANT_LENGTH.index_offset
    return [(i, vl1[0 + off] * vl2[i + off]) for i in range(1, VARIANT_LENGTH.max + 1)]


def hetero_InsIns_tuples_from(vl1, vl2, extra):
    off = VARIANT_LENGTH.index_offset
    out = []
    for i in range(1, VARIANT_LENGTH.max + 1):
        for j in range(i, VARIANT_LENGTH.max + 1):
            out.append(((i, j), vl1[i + off] * vl2[j + off] * extra))
    return out


def homo_Del_tuples_from(vl1, vl2, extra):
    off = VARIANT_LENGTH.index_offset
    return [(i, vl1[-i + off] * vl2[-i + off] * extra)
            for i in range(1, VARIANT_LENGTH.max + 1)]


def hetero_Del_tuples_from(vl1, vl2):
    off = VARIANT_LENGTH.index_offset
    return [(i, vl1[-i + off] * vl2[0 + off]) for i in range(1, VARIANT_LENGTH.max + 1)]


def hetero_DelDel_tuples_from(vl1, vl2, extra):
    off = VARIANT_LENGTH.index_offset
    out = []
    for i in range(1, VARIANT_LENGTH.max + 1):
        for j in range(1, VARIANT_LENGTH.max + 1):
            if i == j and i != off and j != off:
                continue
            out.append(((i, j) if i < j else (j, i), vl1[-i + off] * vl2[-j + off] * extra))
    return out


def hetero_InsDel_tuples_from(vl1, vl2, extra):
    off = VARIANT_LENGTH.index_offset
    out = []
    for i in range(1, VARIANT_LENGTH.max + 1):
        for j in range(1, VARIANT_LENGTH.max + 1):
            out.append(((i, j), vl1[-i + off] * vl2[j + off] * extra))
    return out


def possible_outcome_probabilities(gt21_probabilities, genotype_probabilities,
                                   vl1, vl2, reference_base, add_indel_length):
    """Port of possible_outcome_probabilites_from
    (clair3_rna/call_variants.py:518-667), incl. the homRef early exit."""
    homo_reference_probability = genotype_probabilities[Genotype.homo_reference]
    homo_variant_probability = genotype_probabilities[Genotype.homo_variant]
    hetero_variant_probability = genotype_probabilities[Genotype.hetero_variant]
    reference_gt21 = gt21_from_label(reference_base + reference_base)

    if not add_indel_length:
        homo_Ref_probability = homo_reference_probability * gt21_probabilities[reference_gt21]
        homo_SNP_probabilities = [homo_variant_probability * gt21_probabilities[g]
                                  for g in HOMO_SNP_GT21]
        hetero_SNP_probabilities = [hetero_variant_probability * gt21_probabilities[g]
                                    for g in HETERO_SNP_GT21]
        if homo_reference_probability >= 0.5 and gt21_probabilities[reference_gt21] >= 0.5:
            return [homo_Ref_probability]
        homo_Ins_probabilities = [homo_variant_probability * gt21_probabilities[GT21.InsIns]]
        homo_Ins_lengths = []
        hetero_InsIns_probabilities = [hetero_variant_probability * gt21_probabilities[GT21.InsIns]]
        hetero_InsIns_length_tuples = []
        hetero_ACGT_Ins_probabilities = [
            gt21_probabilities[g] * hetero_variant_probability
            for g in (GT21.AIns, GT21.CIns, GT21.GIns, GT21.TIns)]
        hetero_ACGT_Ins_bases, hetero_ACGT_Ins_lengths = [], []
        homo_Del_probabilities = [homo_variant_probability * gt21_probabilities[GT21.DelDel]]
        homo_Del_lengths = []
        hetero_DelDel_probabilities = [hetero_variant_probability * gt21_probabilities[GT21.DelDel]]
        hetero_DelDel_length_tuples = []
        hetero_ACGT_Del_probabilities = [
            gt21_probabilities[g] * hetero_variant_probability
            for g in (GT21.ADel, GT21.CDel, GT21.GDel, GT21.TDel)]
        hetero_ACGT_Del_bases, hetero_ACGT_Del_lengths = [], []
        hetero_InsDel_probabilities = [hetero_variant_probability * gt21_probabilities[GT21.InsDel]]
        hetero_InsDel_length_tuples = []
    else:
        off = VARIANT_LENGTH.index_offset
        vl0_1, vl0_2 = vl1[0 + off], vl2[0 + off]
        variant_length_0_probability = vl0_1 * vl0_2
        homo_Ref_probability = (variant_length_0_probability * homo_reference_probability
                                * gt21_probabilities[reference_gt21])
        if vl0_1 >= 0.5 and vl0_2 >= 0.5 and homo_reference_probability >= 0.5 \
                and gt21_probabilities[reference_gt21] >= 0.5:
            return [homo_Ref_probability]
        homo_SNP_probabilities = [
            variant_length_0_probability * homo_variant_probability * gt21_probabilities[g]
            for g in HOMO_SNP_GT21]
        hetero_SNP_probabilities = [
            variant_length_0_probability * hetero_variant_probability * gt21_probabilities[g]
            for g in HETERO_SNP_GT21]
        homo_Ins_lengths, homo_Ins_probabilities = map(list, zip(*homo_Ins_tuples_from(
            vl1, vl2, homo_variant_probability * gt21_probabilities[GT21.InsIns])))
        hetero_InsIns_length_tuples, hetero_InsIns_probabilities = map(list, zip(
            *hetero_InsIns_tuples_from(
                vl1, vl2, hetero_variant_probability * gt21_probabilities[GT21.InsIns])))
        hetero_ACGT_Ins_tuples = []
        for length_tuples, p in hetero_Ins_tuples_from(vl1, vl2):
            for g, base in ((GT21.AIns, "A"), (GT21.CIns, "C"),
                            (GT21.GIns, "G"), (GT21.TIns, "T")):
                hetero_ACGT_Ins_tuples.append(
                    (base, length_tuples, p * gt21_probabilities[g] * hetero_variant_probability))
        hetero_ACGT_Ins_bases, hetero_ACGT_Ins_lengths, hetero_ACGT_Ins_probabilities = \
            map(list, zip(*hetero_ACGT_Ins_tuples))
        homo_Del_lengths, homo_Del_probabilities = map(list, zip(*homo_Del_tuples_from(
            vl1, vl2, homo_variant_probability * gt21_probabilities[GT21.DelDel])))
        hetero_DelDel_length_tuples, hetero_DelDel_probabilities = map(list, zip(
            *hetero_DelDel_tuples_from(
                vl1, vl2, hetero_variant_probability * gt21_probabilities[GT21.DelDel])))
        hetero_ACGT_Del_tuples = []
        for length_tuples, p in hetero_Del_tuples_from(vl1, vl2):
            for g, base in ((GT21.ADel, "A"), (GT21.CDel, "C"),
                            (GT21.GDel, "G"), (GT21.TDel, "T")):
                hetero_ACGT_Del_tuples.append(
                    (base, length_tuples, p * gt21_probabilities[g] * hetero_variant_probability))
        hetero_ACGT_Del_bases, hetero_ACGT_Del_lengths, hetero_ACGT_Del_probabilities = \
            map(list, zip(*hetero_ACGT_Del_tuples))
        hetero_InsDel_length_tuples, hetero_InsDel_probabilities = map(list, zip(
            *hetero_InsDel_tuples_from(
                vl1, vl2, hetero_variant_probability * gt21_probabilities[GT21.InsDel])))

    return (
        homo_Ref_probability,
        homo_SNP_probabilities,
        hetero_SNP_probabilities,
        homo_Ins_lengths, homo_Ins_probabilities,
        hetero_InsIns_length_tuples, hetero_InsIns_probabilities,
        hetero_ACGT_Ins_bases, hetero_ACGT_Ins_lengths, hetero_ACGT_Ins_probabilities,
        homo_Del_lengths, homo_Del_probabilities,
        hetero_DelDel_length_tuples, hetero_DelDel_probabilities,
        hetero_ACGT_Del_bases, hetero_ACGT_Del_lengths, hetero_ACGT_Del_probabilities,
        hetero_InsDel_length_tuples, hetero_InsDel_probabilities,
    )


def find_alt_base(alt_info_dict, alternate_base=None):
    """Re-check the network's SNP base against read evidence
    (clair3_rna/call_variants.py:670-681)."""
    max_depth_gap = 9
    sorted_alt_bases = sorted(
        [(alt_base[1], count) for alt_base, count in alt_info_dict.items()
         if alt_base[0] == "X"],
        key=lambda x: x[1], reverse=True)
    alt_count = [item[1] for item in sorted_alt_bases if item[0] == alternate_base]
    if not len(sorted_alt_bases):
        return [], None
    if not len(alt_count) or sorted_alt_bases[0][1] - alt_count[0] >= max_depth_gap:
        alternate_base = sorted_alt_bases[0][0]
    sorted_alt_bases = [item[0] for item in sorted_alt_bases]
    return sorted_alt_bases, alternate_base


def output_from(reference_sequence, tensor_position_center, gt21_probabilities,
                genotype_probabilities, vl1, vl2, call_cfg: CallConfig,
                alt_info_dict):
    """Port of output_from (clair3_rna/call_variants.py:684-1020)."""
    add_indel_length = call_cfg.add_indel_length
    reference_base_ACGT = BASE2ACGT[reference_sequence[tensor_position_center]]
    all_pro = possible_outcome_probabilities(
        gt21_probabilities, genotype_probabilities, vl1, vl2,
        reference_base_ACGT, add_indel_length)

    if len(all_pro) == 1:
        return ((True, False, False, False, False, False, False, False, False, False),
                (reference_base_ACGT, reference_base_ACGT), all_pro[0])
    (
        homo_Ref_probability,
        homo_SNP_probabilities,
        hetero_SNP_probabilities,
        homo_Ins_lengths, homo_Ins_probabilities,
        hetero_InsIns_length_tuples, hetero_InsIns_probabilities,
        hetero_ACGT_Ins_bases, hetero_ACGT_Ins_lengths, hetero_ACGT_Ins_probabilities,
        homo_Del_lengths, homo_Del_probabilities,
        hetero_DelDel_length_tuples, hetero_DelDel_probabilities,
        hetero_ACGT_Del_bases, hetero_ACGT_Del_lengths, hetero_ACGT_Del_probabilities,
        hetero_InsDel_length_tuples, hetero_InsDel_probabilities,
    ) = all_pro
    max_infer = call_cfg.maximum_variant_length_that_need_infer
    maximum_probability = 0.0
    reference_base, alternate_base = None, None
    while reference_base is None or alternate_base is None:
        maximum_probability = max(
            homo_Ref_probability,
            max(homo_SNP_probabilities),
            max(hetero_SNP_probabilities),
            max(homo_Ins_probabilities) if len(homo_Ins_probabilities) else 0,
            max(homo_Del_probabilities) if len(homo_Del_probabilities) else 0,
            max(hetero_ACGT_Ins_probabilities) if len(hetero_ACGT_Ins_probabilities) else 0,
            max(hetero_InsIns_probabilities) if len(hetero_InsIns_probabilities) else 0,
            max(hetero_ACGT_Del_probabilities) if len(hetero_ACGT_Del_probabilities) else 0,
            max(hetero_DelDel_probabilities) if len(hetero_DelDel_probabilities) else 0,
            max(hetero_InsDel_probabilities) if len(hetero_InsDel_probabilities) else 0,
        )
        is_reference = maximum_probability == homo_Ref_probability
        if is_reference:
            return ((True, False, False, False, False, False, False, False, False, False),
                    (reference_base_ACGT, reference_base_ACGT), maximum_probability)

        is_homo_SNP = maximum_probability in homo_SNP_probabilities
        is_hetero_SNP = maximum_probability in hetero_SNP_probabilities
        is_homo_insertion = maximum_probability in homo_Ins_probabilities
        is_hetero_ACGT_Ins = maximum_probability in hetero_ACGT_Ins_probabilities
        is_hetero_InsIns = maximum_probability in hetero_InsIns_probabilities
        is_homo_deletion = maximum_probability in homo_Del_probabilities
        is_hetero_ACGT_Del = maximum_probability in hetero_ACGT_Del_probabilities
        is_hetero_DelDel = maximum_probability in hetero_DelDel_probabilities
        is_insertion_and_deletion = maximum_probability in hetero_InsDel_probabilities

        if is_homo_SNP:
            reference_base = reference_sequence[tensor_position_center]
            idx = homo_SNP_probabilities.index(maximum_probability)
            output_bases = HOMO_SNP_LABELS[int(np.argmax(homo_SNP_probabilities))]
            base1, base2 = output_bases[0], output_bases[1]
            alternate_base = base1 if base1 != reference_base else base2
            sorted_alt_bases, alternate_base = find_alt_base(alt_info_dict, alternate_base)
            if alternate_base is None or alternate_base == reference_base:
                homo_SNP_probabilities[idx] = 0
                continue

        elif is_hetero_SNP:
            output_bases = HETERO_SNP_LABELS[int(np.argmax(hetero_SNP_probabilities))]
            base1, base2 = output_bases[0], output_bases[1]
            idx = hetero_SNP_probabilities.index(maximum_probability)
            reference_base = reference_sequence[tensor_position_center]
            is_multi = base1 != reference_base and base2 != reference_base
            if is_multi:
                sorted_alt_bases, _ = find_alt_base(alt_info_dict)
                if len(sorted_alt_bases) < 2:
                    hetero_SNP_probabilities[idx] = 0
                    continue
                alternate_base = ",".join(sorted_alt_bases[:2])
            else:
                alternate_base = base1 if base1 != reference_base else base2
                sorted_alt_bases, alternate_base = find_alt_base(alt_info_dict, alternate_base)
                if alternate_base is None or alternate_base == reference_base:
                    hetero_SNP_probabilities[idx] = 0
                    continue

        elif is_homo_insertion:
            variant_length = None
            idx = homo_Ins_probabilities.index(maximum_probability)
            if add_indel_length:
                variant_length = homo_Ins_lengths[idx]
            insertion_bases = insertion_bases_from(
                alt_info_dict,
                propose_insertion_length=variant_length
                if variant_length and variant_length < VARIANT_LENGTH.max else None,
                maximum_insertion_length=max_infer)
            if len(insertion_bases) == 0:
                homo_Ins_probabilities[idx] = 0
                continue
            reference_base = reference_sequence[tensor_position_center]
            alternate_base = insertion_bases

        elif is_hetero_ACGT_Ins:
            idx = hetero_ACGT_Ins_probabilities.index(maximum_probability)
            variant_length = None
            if add_indel_length:
                hetero_Ins_base = hetero_ACGT_Ins_bases[idx]
                variant_length = hetero_ACGT_Ins_lengths[idx]
            else:
                hetero_Ins_base = ACGT[idx]
            insertion_bases = insertion_bases_from(
                alt_info_dict,
                propose_insertion_length=variant_length
                if variant_length and variant_length < VARIANT_LENGTH.max else None,
                maximum_insertion_length=max_infer)
            if len(insertion_bases) == 0:
                hetero_ACGT_Ins_probabilities[idx] = 0
                continue
            reference_base = reference_sequence[tensor_position_center]
            alternate_base = insertion_bases
            if hetero_Ins_base != reference_base:
                sorted_alt_bases, _ = find_alt_base(alt_info_dict)
                if len(sorted_alt_bases) == 0:
                    hetero_ACGT_Ins_probabilities[idx] = 0
                    continue
                alternate_base = "{},{}".format(sorted_alt_bases[0], alternate_base)

        elif is_hetero_InsIns:
            insertion_bases_list = []
            idx = hetero_InsIns_probabilities.index(maximum_probability)
            if add_indel_length:
                variant_length_1, variant_length_2 = hetero_InsIns_length_tuples[idx]
                insertion_bases1 = insertion_bases_from(
                    alt_info_dict,
                    propose_insertion_length=variant_length_1
                    if variant_length_1 and variant_length_1 < VARIANT_LENGTH.max else None,
                    maximum_insertion_length=max_infer)
                if len(insertion_bases1):
                    insertion_bases2 = insertion_bases_from(
                        alt_info_dict,
                        propose_insertion_length=variant_length_2
                        if variant_length_2 and variant_length_2 < VARIANT_LENGTH.max else None,
                        insertion_bases_to_ignore=insertion_bases1,
                        maximum_insertion_length=max_infer)
                    if len(insertion_bases2):
                        insertion_bases_list = [insertion_bases1, insertion_bases2]
                if len(insertion_bases_list) < 2:
                    insertion_bases_list = insertion_bases_from(
                        alt_info_dict, return_multi=True,
                        maximum_insertion_length=max_infer)
            else:
                insertion_bases_list = insertion_bases_from(
                    alt_info_dict, return_multi=True, maximum_insertion_length=max_infer)
            if len(insertion_bases_list) < 2:
                hetero_InsIns_probabilities[idx] = 0
                continue
            insertion_bases, another_insertion_bases = insertion_bases_list
            reference_base = reference_sequence[tensor_position_center]
            alternate_base = insertion_bases
            alternate_base_1 = another_insertion_bases
            alternate_base_2 = alternate_base
            if alternate_base_1 != alternate_base_2:
                alternate_base = "{},{}".format(alternate_base_1, alternate_base_2)
            else:
                hetero_InsIns_probabilities[idx] = 0
                continue

        elif is_homo_deletion:
            variant_length = None
            idx = homo_Del_probabilities.index(maximum_probability)
            if add_indel_length:
                variant_length = homo_Del_lengths[idx]
            deletion_bases = deletion_bases_from(
                alt_info_dict,
                propose_deletion_length=variant_length
                if variant_length and variant_length < VARIANT_LENGTH.max else None,
                maximum_deletion_length=max_infer)
            if len(deletion_bases) == 0:
                homo_Del_probabilities[idx] = 0
                continue
            reference_base = reference_sequence[tensor_position_center] + deletion_bases
            alternate_base = reference_base[0]

        elif is_hetero_ACGT_Del:
            variant_length = None
            idx = hetero_ACGT_Del_probabilities.index(maximum_probability)
            if add_indel_length:
                variant_length = hetero_ACGT_Del_lengths[idx]
                hetero_Del_base = hetero_ACGT_Del_bases[idx]
            else:
                hetero_Del_base = ACGT[idx]
            deletion_bases = deletion_bases_from(
                alt_info_dict,
                propose_deletion_length=variant_length
                if variant_length and variant_length < VARIANT_LENGTH.max else None,
                maximum_deletion_length=max_infer)
            if len(deletion_bases) == 0:
                hetero_ACGT_Del_probabilities[idx] = 0
                continue
            reference_base = reference_sequence[tensor_position_center] + deletion_bases
            alternate_base = reference_base[0]
            if hetero_Del_base != reference_base[0]:
                alternate_base_1 = alternate_base
                alternate_base_2 = hetero_Del_base + reference_base[1:]
                alternate_base = "{},{}".format(alternate_base_1, alternate_base_2)

        elif is_hetero_DelDel:
            deletion_bases_list = []
            idx = hetero_DelDel_probabilities.index(maximum_probability)
            if add_indel_length:
                variant_length_1, variant_length_2 = sorted(
                    hetero_DelDel_length_tuples[idx], reverse=True)
                deletion_base1 = deletion_bases_from(
                    alt_info_dict,
                    propose_deletion_length=variant_length_1
                    if variant_length_1 and variant_length_1 < VARIANT_LENGTH.max else None,
                    maximum_deletion_length=max_infer)
                if len(deletion_base1) > 0:
                    deletion_base2 = deletion_bases_from(
                        alt_info_dict,
                        propose_deletion_length=variant_length_2
                        if variant_length_2 and variant_length_2 < VARIANT_LENGTH.max else None,
                        deletion_bases_to_ignore=deletion_base1,
                        maximum_deletion_length=max_infer)
                    if len(deletion_base2) > 0:
                        deletion_bases_list = [deletion_base1, deletion_base2] \
                            if len(deletion_base1) > len(deletion_base2) \
                            else [deletion_base2, deletion_base1]
                if len(deletion_bases_list) < 2:
                    deletion_bases_list = deletion_bases_from(
                        alt_info_dict, return_multi=True, maximum_deletion_length=max_infer)
            else:
                deletion_bases_list = deletion_bases_from(
                    alt_info_dict, return_multi=True, maximum_deletion_length=max_infer)
            if len(deletion_bases_list) < 2:
                hetero_DelDel_probabilities[idx] = 0
                continue
            deletion_bases, deletion_bases1 = deletion_bases_list
            reference_base = reference_sequence[tensor_position_center] + deletion_bases
            alternate_base = reference_base[0]
            alternate_base_1 = alternate_base
            alternate_base_2 = reference_base[0] + reference_base[len(deletion_bases1) + 1:]
            if (alternate_base_1 != alternate_base_2
                    and reference_base != alternate_base_1
                    and reference_base != alternate_base_2):
                alternate_base = "{},{}".format(alternate_base_1, alternate_base_2)
            else:
                hetero_DelDel_probabilities[idx] = 0
                continue

        elif is_insertion_and_deletion:
            variant_length_1, variant_length_2 = None, None
            idx = hetero_InsDel_probabilities.index(maximum_probability)
            if add_indel_length:
                variant_length_1, variant_length_2 = hetero_InsDel_length_tuples[idx]
            insertion_bases = insertion_bases_from(
                alt_info_dict,
                propose_insertion_length=variant_length_2
                if variant_length_2 and variant_length_2 < VARIANT_LENGTH.max else None,
                maximum_insertion_length=max_infer)
            deletion_bases = deletion_bases_from(
                alt_info_dict,
                propose_deletion_length=variant_length_1
                if variant_length_1 and variant_length_1 < VARIANT_LENGTH.max else None,
                maximum_deletion_length=max_infer)
            if len(insertion_bases) == 0 or len(deletion_bases) == 0:
                hetero_InsDel_probabilities[idx] = 0
                continue
            reference_base = reference_sequence[tensor_position_center] + deletion_bases
            alternate_base = "{},{}".format(
                reference_base[0], insertion_bases + reference_base[1:])

    return (
        (is_reference, is_homo_SNP, is_hetero_SNP,
         is_homo_insertion, is_hetero_ACGT_Ins, is_hetero_InsIns,
         is_homo_deletion, is_hetero_ACGT_Del, is_hetero_DelDel,
         is_insertion_and_deletion),
        (reference_base, alternate_base), maximum_probability)


def compute_PL(genotype_str, genotype_probabilities, gt21_probabilities,
               reference_base, alternate_base):
    """PL computation for GVCF output (clair3_rna/call_variants.py:1395-1452)."""
    alt_array = alternate_base.split(",")
    alt_num = len(alt_array)
    genotypes = {1: [[0, 0], [0, 1], [1, 1]],
                 2: [[0, 0], [0, 1], [1, 1], [0, 2], [1, 2], [2, 2]]}
    likelihoods = []
    reference_base = BASE2ACGT[reference_base] if len(reference_base) == 1 else reference_base
    all_base = [reference_base]
    all_base.extend(alt_array)
    for encoded in genotypes[alt_num]:
        p1 = partial_label(reference_base, all_base[encoded[0]])
        p2 = partial_label(reference_base, all_base[encoded[1]])
        label = mix_partial_labels(p1, p2)
        try:
            gt21_prob_index = gt21_from_label(label)
        except KeyError:
            if alternate_base == ".":
                return [990]
            return [990] * len(genotypes[alt_num])
        genotype_prob_21 = gt21_probabilities[gt21_prob_index]
        _genotype = genotype_enum_for_task(genotype_enum_from(encoded[0], encoded[1]))
        likelihoods.append(genotype_prob_21 * genotype_probabilities[_genotype])
    sum_p = sum(likelihoods)
    LOG_10 = math.log(10.0)
    likelihoods = [x / sum_p for x in likelihoods]
    likelihoods = [x + 1e-8 for x in likelihoods]
    PLs = [-10 * (log(x) / LOG_10) for x in likelihoods]
    min_PL = min(PLs)
    return [int(math.ceil(x - min_PL)) for x in PLs]


def parse_alt_info(alt_info: str):
    """'depth-K c K c ...' -> (read_depth, {key: count})."""
    parts = alt_info.rstrip().split("-")
    read_depth = int(parts[0])
    indel_str = parts[1] if len(parts) > 1 else ""
    seqs = indel_str.split(" ")
    alt_info_dict = dict(zip(seqs[::2], [int(v) for v in seqs[1::2]])) if len(seqs) else {}
    return read_depth, alt_info_dict


def decode_one(chromosome, position, reference_sequence, alt_info,
               gt21_probabilities, genotype_probabilities, vl1, vl2,
               call_cfg: CallConfig):
    """Port of output_with (clair3_rna/call_variants.py:1117-1392).

    Returns the VCF row string, or None when the site produces no output.
    """
    tensor_position_center = config.FLANKING_BASE_NUM if len(reference_sequence) > 1 else 0
    if isinstance(alt_info, str):
        read_depth, alt_info_dict = parse_alt_info(alt_info)
    else:  # pre-parsed (depth, {key: count}) from TensorRecord.alt_data
        read_depth, alt_info_dict = alt_info

    output_info = output_from(
        reference_sequence, tensor_position_center, gt21_probabilities,
        genotype_probabilities, vl1, vl2, call_cfg, alt_info_dict)
    if output_info is None:
        return None
    (
        (is_reference, is_homo_SNP, is_hetero_SNP,
         is_homo_insertion, is_hetero_ACGT_Ins, is_hetero_InsIns,
         is_homo_deletion, is_hetero_ACGT_Del, is_hetero_DelDel,
         is_insertion_and_deletion),
        (reference_base, alternate_base), maximum_probability) = output_info

    if (not call_cfg.show_ref and is_reference) or \
            (not is_reference and reference_base == alternate_base):
        return None
    if reference_base is None or alternate_base is None:
        return None

    is_multi = "," in str(alternate_base)
    if call_cfg.haploid_precise and (
            is_hetero_SNP or is_hetero_ACGT_Ins or is_hetero_InsIns
            or is_hetero_ACGT_Del or is_hetero_DelDel or is_insertion_and_deletion):
        return None
    if call_cfg.haploid_sensitive and is_multi:
        return None

    if is_reference:
        genotype_str = genotype_string(Genotype.homo_reference)
    elif is_homo_SNP or is_homo_insertion or is_homo_deletion:
        genotype_str = genotype_string(Genotype.homo_variant)
    elif is_hetero_SNP or is_hetero_ACGT_Ins or is_hetero_InsIns \
            or is_hetero_ACGT_Del or is_hetero_DelDel:
        genotype_str = genotype_string(Genotype.hetero_variant)
    if is_multi:
        genotype_str = genotype_string(Genotype.hetero_variant_multi)

    alt_type_list = [{}, {}, {}]  # SNP, Ins, Del
    ref_count = 0
    for alt_type, count in alt_info_dict.items():
        count = int(count)
        if alt_type[0] == "X":
            alt_type_list[0][alt_type[1]] = count
        elif alt_type[0] == "I":
            alt_type_list[1][alt_type[1:]] = count
        elif alt_type[0] == "D":
            alt_type_list[2][alt_type[1:]] = count
        elif alt_type[0] == "R":
            ref_count = count
    ref_count = max(0, ref_count)

    supported_reads_count = 0
    alt_list_count = []
    enable_long_indel = call_cfg.enable_long_indel

    if is_reference:
        supported_reads_count = ref_count
        alternate_base = "."
    elif is_homo_SNP or is_hetero_SNP:
        for base in str(alternate_base):
            if base == ",":
                continue
            supported_reads_count += alt_type_list[0].get(base, 0)
            alt_list_count.append(supported_reads_count)
    elif is_homo_insertion or is_hetero_InsIns:
        for ins_bases in alternate_base.split(","):
            long_ins = get_long_indel_read_count(
                alt_type_list[1], proposed_ins_base=ins_bases, is_del=False) \
                if enable_long_indel else 0
            count = alt_type_list[1].get(ins_bases, 0) + long_ins
            supported_reads_count += count
            alt_list_count.append(count)
    elif is_hetero_ACGT_Ins:
        is_SNP_Ins_multi = is_multi
        SNP_base = alternate_base.split(",")[0][0] if is_SNP_Ins_multi else None
        ins_bases = alternate_base.split(",")[1] if is_SNP_Ins_multi else alternate_base
        supported_reads_for_SNP = alt_type_list[0].get(SNP_base, 0) if is_SNP_Ins_multi else 0
        long_ins = get_long_indel_read_count(
            alt_type_list[1], proposed_ins_base=ins_bases, is_del=False) \
            if enable_long_indel else 0
        supported_reads_for_ins = alt_type_list[1].get(ins_bases, 0) + long_ins
        supported_reads_count = supported_reads_for_ins + supported_reads_for_SNP
        if SNP_base:
            alt_list_count.append(supported_reads_for_SNP)
        alt_list_count.append(supported_reads_for_ins)
    elif is_homo_deletion or is_hetero_DelDel:
        if len(alt_type_list[2]) > 0:
            if is_homo_deletion:
                del_bases = reference_base[1:] if len(reference_base) > 1 else None
                long_del = get_long_indel_read_count(
                    alt_type_list[2], propose_del_base_length=len(del_bases)) \
                    if enable_long_indel else 0
                supported_reads_count = alt_type_list[2].get(del_bases, 0) + long_del
                alt_list_count.append(supported_reads_count)
            elif is_hetero_DelDel and len(alt_type_list[2]) > 1:
                for _bases in alternate_base.split(","):
                    _alt_len = len(reference_base) - len(_bases)
                    _tmp_cnt = [alt_type_list[2][k] for k in alt_type_list[2]
                                if len(k) == _alt_len]
                    long_del = get_long_indel_read_count(
                        alt_type_list[2], propose_del_base_length=_alt_len) \
                        if enable_long_indel else 0
                    _read_count = (_tmp_cnt[0] if len(_tmp_cnt) > 0 else 0) + long_del
                    alt_list_count.append(_read_count)
                    supported_reads_count += _read_count
    elif is_hetero_ACGT_Del:
        alt_list = alternate_base.split(",")
        is_SNP_Del_multi = False if len(alt_list) == 0 else is_multi
        SNP_base = (alt_list[1][0] if len(alt_list) > 1 else None) \
            if is_SNP_Del_multi else None
        supported_reads_for_SNP = alt_type_list[0].get(SNP_base, 0) \
            if is_SNP_Del_multi else 0
        del_bases = reference_base[1:] if len(reference_base) > 1 else None
        long_del = get_long_indel_read_count(
            alt_type_list[2], propose_del_base_length=len(del_bases)) \
            if enable_long_indel else 0
        supported_reads_for_del = alt_type_list[2].get(del_bases, 0) + long_del
        supported_reads_count = supported_reads_for_del + supported_reads_for_SNP
        if SNP_base:
            alt_list_count.append(supported_reads_for_SNP)
        alt_list_count.append(supported_reads_for_del)
    elif is_insertion_and_deletion:
        for _bases in alternate_base.split(","):
            _alt_len = len(reference_base) - len(_bases)
            if _alt_len < 0:  # ins
                ins_bases = _bases[:-(len(reference_base) - 1)] \
                    if len(reference_base) > 1 else _bases
                long_ins = get_long_indel_read_count(
                    alt_type_list[1], proposed_ins_base=ins_bases, is_del=False) \
                    if enable_long_indel else 0
                _read_count = alt_type_list[1].get(ins_bases, 0) + long_ins
            else:  # del
                _tmp_cnt = [alt_type_list[2][k] for k in alt_type_list[2]
                            if len(k) == _alt_len]
                long_del = get_long_indel_read_count(
                    alt_type_list[2], propose_del_base_length=_alt_len) \
                    if enable_long_indel else 0
                _read_count = (_tmp_cnt[0] if len(_tmp_cnt) > 0 else 0) + long_del
            alt_list_count.append(_read_count)
            supported_reads_count += _read_count

    allele_frequency = (supported_reads_count + 0.0) / read_depth if read_depth != 0 else 0.0
    if allele_frequency > 1:
        allele_frequency = 1

    quality_score = quality_score_from(maximum_probability)
    if call_cfg.haploid_precise or call_cfg.haploid_sensitive:
        genotype_str = "1" if "1" in genotype_str else "0"
    filtration_value = filtration_value_from(
        quality_score_for_pass=call_cfg.qual, quality_score=quality_score,
        is_reference=is_reference)

    if not call_cfg.keep_iupac_bases:
        reference_base = convert_iupac_to_n(reference_base)
        alternate_base = convert_iupac_to_n(alternate_base)

    if call_cfg.debug:
        # raw probability dump instead of the VCF row
        # (clair3_rna/call_variants.py:273-290,1340-1349)
        return "{}\t{}\t{}\t{}\t{}\t{}\t{}".format(
            chromosome, position,
            ["{:0.8f}".format(x) for x in gt21_probabilities],
            ["{:0.8f}".format(x) for x in genotype_probabilities],
            ["{:0.8f}".format(x) for x in (vl1 if vl1 is not None else [])],
            ["{:0.8f}".format(x) for x in (vl2 if vl2 is not None else [])],
            "Normal output" if not is_reference else "Reference")

    ad_alt = "," + ",".join(str(item) for item in alt_list_count)
    allele_depth = str(ref_count) + (ad_alt if len(alt_list_count) else "")
    allele_frequency_s = "%.4f" % allele_frequency if len(alt_list_count) <= 1 else \
        ",".join("%.4f" % min(1.0, 1.0 * item / read_depth) for item in alt_list_count)

    if call_cfg.gvcf:
        PLs = compute_PL(genotype_str, genotype_probabilities, gt21_probabilities,
                         reference_base, alternate_base)
        PLs = ",".join(str(x) for x in PLs)
        return "%s\t%d\t.\t%s\t%s\t%.2f\t%s\t%s\tGT:GQ:DP:AD:AF:PL\t%s:%d:%d:%s:%s:%s" % (
            chromosome, position, reference_base, alternate_base, quality_score,
            filtration_value, ".", genotype_str, quality_score, read_depth,
            allele_depth, allele_frequency_s, PLs)
    return "%s\t%d\t.\t%s\t%s\t%.2f\t%s\t%s\tGT:GQ:DP:AD:AF\t%s:%d:%d:%s:%s" % (
        chromosome, position, reference_base, alternate_base, quality_score,
        filtration_value, ".", genotype_str, quality_score, read_depth,
        allele_depth, allele_frequency_s)


def decode_batch(chrom_list, position_list, refseq_list, alt_info_list,
                 probabilities, call_cfg: CallConfig):
    """Decode a batch of network outputs into VCF rows (skipping None)."""
    probabilities = np.asarray(probabilities)
    gt21 = probabilities[:, :config.LABEL_SHAPE_CUM[0]]
    genotype = probabilities[:, config.LABEL_SHAPE_CUM[0]:config.LABEL_SHAPE_CUM[1]]
    if call_cfg.add_indel_length:
        vl1 = probabilities[:, config.LABEL_SHAPE_CUM[1]:config.LABEL_SHAPE_CUM[2]]
        vl2 = probabilities[:, config.LABEL_SHAPE_CUM[2]:config.LABEL_SHAPE_CUM[3]]
    else:
        vl1 = vl2 = [None] * len(probabilities)
    rows = []
    for i in range(len(probabilities)):
        row = decode_one(chrom_list[i], position_list[i], refseq_list[i],
                         alt_info_list[i], gt21[i], genotype[i],
                         vl1[i], vl2[i], call_cfg)
        if row is not None:
            rows.append(row)
    return rows
