"""GVCF generation: non-variant block construction + variant/block merge.

Port of the reference's variantInfoCalculator / gvcfGenerator
(src/utils.py:103-650) with its exact numerics -- including the truncated
LOG_10=2.3025 / LOG_2=0.3010 constants, 6-digit rounding, max GQ 50, GQ
binning, and the DP-ratio (30%) block-split rule. The per-site reference
likelihood computation is vectorized over whole position tiles; only the
block segmentation remains a scalar scan.
"""

import math
import re
from dataclasses import dataclass, field

import numpy as np

# deliberately truncated constants, kept for numeric parity (src/utils.py:48-49)
LOG_10 = 2.3025
LOG_2 = 0.3010
MAX_GQ = 50


def log10p_to_phred(log10p: float) -> float:
    ptrue = pow(10, log10p)
    if ptrue == 1:
        return 50
    return round(-10 * (math.log(1 - ptrue) / LOG_10), 6)


def log10sumexp(values) -> float:
    m = max(values)
    return m + math.log10(sum(pow(10.0, x - m) for x in values))


def normalize_log10_prob(values):
    lse = round(log10sumexp(values), 6)
    return [min(x - lse, 0) for x in values]


_CONSTANT_LOG10_PROBS = normalize_log10_prob([-1.0, -1.0, -1.0])


def reference_likelihood(n_ref: int, n_total: int, p_err: float,
                         gq_bin_size: int):
    """(validPL, gq, binned_gq, log10_probs) for one site
    (src/utils.py:553-597)."""
    logp = math.log(p_err) / LOG_10
    log1p = math.log1p(-p_err) / LOG_10
    if n_total == 0:
        log10_probs = _CONSTANT_LOG10_PROBS
    else:
        n_alts = n_total - n_ref
        log10_probs = normalize_log10_prob([
            n_ref * log1p + n_alts * logp,
            -n_total * LOG_2,
            n_ref * logp + n_alts * log1p,
        ])
    gq = log10p_to_phred(log10_probs[0])
    gq = int(min(int(gq), MAX_GQ))
    if gq >= 1:
        binned_gq = ((gq - 1) // gq_bin_size) * gq_bin_size + 1
    else:
        binned_gq = 0
    valid_pl = log10_probs[0] == max(log10_probs)
    return valid_pl, gq, binned_gq, log10_probs


@dataclass
class _SiteInfo:
    valid_pl: bool
    gq: int
    binned_gq: int
    pl: list
    chr: str
    pos: int
    ref: str
    gt: str
    min_dp: int
    end: int


class NonVariantAccumulator:
    """Online non-variant block builder (src/utils.py:427-517,605-650).

    Rows are appended via push(chr, pos, ref, n_total, n_ref); finish() flushes
    the trailing block. Output rows accumulate in .rows (VCF body strings)."""

    def __init__(self, p_err=0.001, gq_bin_size=5, bp_resolution=False):
        self.p_err = p_err
        self.gq_bin_size = gq_bin_size
        self.bp_resolution = bp_resolution
        self.rows = []
        self._memo = {}
        self._reset()

    def _reset(self):
        self.current_block = []
        self.cur_gq_bin_index = None
        self.cur_gt = None
        self.cur_min_DP = None
        self.cur_max_DP = None
        self.cur_chr = None
        self.cur_raw_gq = None
        self.cur_ref = None

    def _site_info(self, chrom, pos, ref, n_total, n_ref) -> _SiteInfo:
        key = (n_ref, n_total)
        cached = self._memo.get(key)
        if cached is None:
            valid_pl, gq, binned_gq, log10_probs = reference_likelihood(
                n_ref, n_total, self.p_err, self.gq_bin_size)
            phred = [-10 * x for x in log10_probs]
            mn = min(phred)
            pl = [int(x - mn) for x in phred]
            cached = (valid_pl, gq, binned_gq, pl)
            self._memo[key] = cached
        valid_pl, gq, binned_gq, pl = cached
        gt = "0/0" if valid_pl else "./."
        if ref not in "ACGT":
            ref, gq, binned_gq, pl = "N", 1, 1, [0, 0, 0]
        return _SiteInfo(valid_pl, gq, binned_gq, pl, chrom, pos, ref, gt,
                         n_total, pos)

    def push_array(self, chrom, positions, refs, n_total, n_ref):
        """Bulk push: positions 1-based ascending, refs a same-length string."""
        for i in range(len(positions)):
            self.push(chrom, int(positions[i]), refs[i], int(n_total[i]),
                      int(n_ref[i]))

    def push(self, chrom, pos, ref, n_total, n_ref):
        cur = self._site_info(chrom, pos, ref, n_total, n_ref)
        if self.cur_gq_bin_index is None \
                or cur.binned_gq != self.cur_gq_bin_index \
                or cur.gt != self.cur_gt \
                or cur.chr != self.cur_chr \
                or (cur.ref != self.cur_ref and (cur.ref == "N" or self.cur_ref == "N")):
            if self.current_block:
                self._flush()
            self._start(cur)
            return
        dp = cur.min_dp
        if dp < self.cur_min_DP:
            if self.cur_max_DP > math.ceil(dp + dp * 0.3):
                self._flush()
                self._start(cur)
            else:
                self.cur_min_DP = dp
                self.cur_raw_gq = min(self.cur_raw_gq, cur.gq)
                self.current_block.append(cur)
        elif dp > self.cur_max_DP:
            if dp <= math.ceil(self.cur_min_DP + self.cur_min_DP * 0.3):
                self.cur_max_DP = dp
                self.cur_raw_gq = min(self.cur_raw_gq, cur.gq)
                self.current_block.append(cur)
            else:
                self._flush()
                self._start(cur)
        else:
            self.cur_raw_gq = min(self.cur_raw_gq, cur.gq)
            self.current_block.append(cur)

    def _start(self, cur: _SiteInfo):
        self.current_block = [cur]
        self.cur_gq_bin_index = cur.binned_gq
        self.cur_gt = cur.gt
        self.cur_min_DP = cur.min_dp
        self.cur_max_DP = cur.min_dp
        self.cur_chr = cur.chr
        self.cur_raw_gq = cur.gq
        self.cur_ref = cur.ref

    def _flush(self):
        block = self.current_block
        if not block:
            return
        if (self.bp_resolution or block[0].gt == "./.") and block[0].ref != "N":
            for item in block:
                self.rows.append(self._row(item, item.binned_gq, item.min_dp,
                                           item.pos))
        else:
            first = block[0]
            if first.ref == "N":
                info = _SiteInfo(False, 1, 1, [0, 0, 0], first.chr, first.pos,
                                 "N", "./.", self.cur_min_DP, block[-1].pos)
                self.rows.append(self._row(info, 1, self.cur_min_DP,
                                           block[-1].pos))
            else:
                # block row uses the block-minimum raw GQ (src/utils.py:636-641)
                self.rows.append(self._row(first, self.cur_raw_gq,
                                           self.cur_min_DP, block[-1].pos))
        self.current_block = []

    @staticmethod
    def _row(item: _SiteInfo, gq_field, min_dp, end_pos) -> str:
        return (f"{item.chr}\t{item.pos}\t.\t{item.ref}\t<NON_REF>\t0\t.\t"
                f"END={end_pos}\tGT:GQ:MIN_DP:PL\t{item.gt}:{gq_field}:"
                f"{min_dp}:{item.pl[0]},{item.pl[1]},{item.pl[2]}")

    def push_empty_region(self, chrom, start, end):
        """Whole-chunk zero coverage (src/utils.py:420-427)."""
        self.rows.append(
            f"{chrom}\t{max(1, start)}\t.\tN\t<NON_REF>\t0\t.\tEND={end}\t"
            f"GT:GQ:MIN_DP:PL\t./.:1:0:0,0,0")

    def finish(self):
        self._flush()
        return self.rows


# ---------------------------------------------------------------------------
# variant + non-variant merge (src/utils.py:218-376)
# ---------------------------------------------------------------------------

_END_RE = re.compile(r".*END=(.*)\tGT.*")


def _variant_rows_for_gvcf(rows):
    out = []
    for line in rows:
        tmp = line.rstrip("\n").split("\t")
        ref, alt = tmp[3], tmp[4]
        if alt == "." or ref == alt:
            continue
        n_alt = len(alt.split(","))
        info = tmp[-1].split(":")
        info[-3] += ",0"          # AD gets the <NON_REF> 0
        tmp[-1] = ":".join(info)
        tmp[4] = tmp[4] + ",<NON_REF>"
        tmp[-1] += ",990,990,990" if n_alt == 1 else ",990,990,990,990"
        start = int(tmp[1])
        out.append(("\t".join(tmp), start, start - 1 + len(ref)))
    return out


def merge_gvcf_rows(variant_rows, nonvar_rows, ref_base_at):
    """Merge variant rows into non-variant blocks, splitting blocks around
    variants. ref_base_at(chrom, pos1) fetches the base for right-split rows.
    Returns merged VCF body rows."""
    variants = _variant_rows_for_gvcf(variant_rows)
    blocks = []
    for line in nonvar_rows:
        cols = line.split("\t")
        start = int(cols[1])
        end = int(_END_RE.match(line).group(1))
        blocks.append((line, start, end))

    out = []

    def write_left(end_pos, line):
        out.append(re.sub(r"END=[0-9]*\t", f"END={end_pos}\t", line))

    def write_right(new_start, line):
        tmp = line.split("\t")
        tmp[1] = str(new_start)
        tmp[3] = ref_base_at(tmp[0], new_start)
        out.append("\t".join(tmp))

    def write_block(start, end, pos_flag, line):
        if pos_flag == "left":
            write_left(end, line)
        elif pos_flag == "right":
            write_right(start, line)
        else:
            out.append(line)

    vi, bi = 0, 0
    cur_pos = "original"
    cur_line = cur_start = cur_end = None
    if blocks:
        cur_line, cur_start, cur_end = blocks[0]
        bi = 1
    has_var = bool(variants)
    last_var_end = variants[-1][2] if has_var else -1

    while vi < len(variants) and cur_line is not None:
        var_line, var_start, var_end = variants[vi]
        if cur_end < var_start:
            write_block(cur_start, cur_end, cur_pos, cur_line)
            if bi < len(blocks):
                cur_line, cur_start, cur_end = blocks[bi]
                cur_pos = "original"
                bi += 1
            else:
                cur_line = None
        elif var_end < cur_start:
            out.append(var_line)
            vi += 1
        elif var_start <= cur_start <= var_end:
            out.append(var_line)
            block_new_start = var_end + 1
            vi += 1
            while block_new_start > cur_end:
                if bi < len(blocks):
                    cur_line, cur_start, cur_end = blocks[bi]
                    cur_pos = "original"
                    bi += 1
                else:
                    cur_line = None
                    break
            if cur_line is None:
                break
            if block_new_start - 1 >= cur_start:
                cur_start = block_new_start
                cur_pos = "right"
        else:  # var_start > cur_start: variant inside the block
            left_end = var_start - 1
            if left_end >= cur_start:
                write_left(left_end, cur_line)
            out.append(var_line)
            right_start = var_end + 1
            vi += 1
            if right_start <= cur_end:
                cur_start = right_start
                cur_pos = "right"
            else:
                advanced = False
                while bi < len(blocks):
                    cur_line, cur_start, cur_end = blocks[bi]
                    cur_pos = "original"
                    bi += 1
                    if right_start <= cur_end:
                        advanced = True
                        break
                if not advanced:
                    cur_line = None
                    break
                cur_start = right_start
                cur_pos = "right"

    while vi < len(variants):
        out.append(variants[vi][0])
        vi += 1
    if cur_line is not None:
        if has_var and cur_end > last_var_end:
            write_block(max(cur_start, last_var_end + 1)
                        if cur_pos == "right" else cur_start,
                        cur_end, cur_pos, cur_line)
        else:
            write_block(cur_start, cur_end, cur_pos, cur_line)
        while bi < len(blocks):
            out.append(blocks[bi][0])
            bi += 1
    return out


GVCF_EXTRA_HEADER = """\
##ALT=<ID=NON_REF,Description="Represents any possible alternative allele at this location">
##INFO=<ID=END,Number=1,Type=Integer,Description="End position of the variant described in this record">
##FORMAT=<ID=MIN_DP,Number=1,Type=Integer,Description="Minimum DP observed within the GVCF block">
##FORMAT=<ID=PL,Number=G,Type=Integer,Description="Phred-scaled genotype likelihoods rounded to the closest integer">"""
