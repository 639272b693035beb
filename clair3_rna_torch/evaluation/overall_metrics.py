"""Coverage/AF-stratified benchmarking metrics.

Capability match for src/calculate_overall_metrics.py:101-442: re-filter a
call-vs-truth comparison by minimum coverage / alt support / AF (from a
'truths' support file), optionally disregard zygosity (allele-match
promotion), and sweep QUAL cutoffs for the best F1. Operates on our
compare_vcf result instead of hap.py-annotated VCFs -- no external hap.py
dependency."""

from dataclasses import dataclass

from clair3_rna_torch.evaluation.compare_vcf import compare_vcf
from clair3_rna_torch.io.vcf import VcfReader


def metrics_from_counts(query_fp, query_tp, truth_fn, truth_tp):
    precision = query_tp / (query_tp + query_fp) if query_tp + query_fp else 0.0
    recall = truth_tp / (truth_tp + truth_fn) if truth_tp + truth_fn else 0.0
    f1 = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
    return round(precision, 6), round(recall, 6), round(f1, 6)


@dataclass
class StratifiedResult:
    qual: float
    precision: float
    recall: float
    f1: float
    tp: int
    fp: int
    fn: int


def stratified_metrics(call_fn, truth_fn, *, truths_support=None, bed_fn=None,
                       ctg_name=None, min_coverage=None, min_alt_coverage=None,
                       min_af=None, skip_genotyping=False, qual_sweep=True):
    """Filter truth sites by support thresholds, then sweep QUAL for best F1.

    truths_support: {(ctg,pos): (cov, [alt_cov], [af])} from
    evaluation.af_distribution.load_truths_file.
    """
    def site_passes(ctg, pos):
        if truths_support is None:
            return True
        info = truths_support.get((ctg, pos))
        if info is None:
            return True
        cov, alts, afs = info
        if min_coverage is not None and cov < min_coverage:
            return False
        if min_alt_coverage is not None and max(alts, default=0) < min_alt_coverage:
            return False
        if min_af is not None and max(afs, default=0.0) < min_af:
            return False
        return True

    base = compare_vcf(call_fn, truth_fn, bed_fn=bed_fn, ctg_name=ctg_name,
                       skip_genotyping=skip_genotyping)
    calls = VcfReader(call_fn, ctg_name=ctg_name, show_ref=False)
    qual_of = {(r.ctg_name, r.pos): (r.qual if r.qual is not None else 0.0)
               for r in calls.variant_dict.values()}

    tp_sites = [(c, p) for c, p, *_ in base.tp_sites if site_passes(c, p)]
    fp_sites = [(c, p) for c, p, *_ in base.fp_sites]
    fn_sites = [(c, p) for c, p, *_ in base.fn_sites if site_passes(c, p)]

    quals = sorted({int(qual_of.get(s, 0)) for s in tp_sites + fp_sites}) \
        if qual_sweep else [0]
    results = []
    for q in quals:
        tp = sum(1 for s in tp_sites if qual_of.get(s, 0) >= q)
        fp = sum(1 for s in fp_sites if qual_of.get(s, 0) >= q)
        fn = len(fn_sites) + (len(tp_sites) - tp)
        pre, rec, f1 = metrics_from_counts(fp, tp, fn, tp)
        results.append(StratifiedResult(q, pre, rec, f1, tp, fp, fn))
    results.sort(key=lambda r: r.f1, reverse=True)
    return results


def print_table(results, limit=5):
    print("QUAL\tPrecision\tRecall\tF1\tTP\tFP\tFN")
    for r in results[:limit]:
        print(f"{r.qual}\t{r.precision:.4f}\t{r.recall:.4f}\t{r.f1:.4f}"
              f"\t{r.tp}\t{r.fp}\t{r.fn}")


# ---------------------------------------------------------------------------
# hap.py-annotated VCF ingestion
# ---------------------------------------------------------------------------
#
# The reference's published numbers are produced by feeding hap.py's annotated
# output VCF (per-site BD/BI/BVT/BK FORMAT tags for both TRUTH and QUERY
# samples) through src/calculate_overall_metrics.py:101-442. happy_metrics
# reproduces that pathway: stratified Overall/SNP/INDEL/INS/DEL counts,
# coverage/alt-support/AF re-filtering from a `truths` support file, qual/DP/AD
# re-filtering from the raw input VCF, allele-match (BK=am) promotion to TP
# when genotyping is disregarded, and the best-F1 SNV qual sweep.

@dataclass
class HappyClassCounts:
    query_fp: int = 0
    query_tp: int = 0
    truth_fn: int = 0
    truth_tp: int = 0

    def metrics(self):
        return metrics_from_counts(self.query_fp, self.query_tp,
                                   self.truth_fn, self.truth_tp)


def _open_maybe_gz(path):
    import gzip
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path)


def happy_metrics(happy_vcf_fn, *, ctg_name=None, truths_support=None,
                  input_vcf_fn=None, input_filter_tag=None, min_qual=None,
                  min_coverage=None, min_alt_coverage=None, min_af=None,
                  skip_genotyping=True):
    """Parse a hap.py-annotated VCF into stratified class counts.

    Mirrors src/calculate_overall_metrics.py:Cal row by row. Returns
    (counts_by_class, snv_sweep_inputs) where counts_by_class maps
    'Overall'/'SNP'/'INDEL'/'INS'/'DEL' -> HappyClassCounts and
    snv_sweep_inputs = (fp_qual_dict, tp_qual_dict, fn_count, tp_count) feeds
    best_f1_sweep.
    """
    # qual/DP/AD re-filter from the raw called VCF
    # (src/calculate_overall_metrics.py:140-177)
    low_confident = set()
    qual_of = {}
    if input_vcf_fn is not None:
        import os
        if not os.path.exists(input_vcf_fn):
            raise FileNotFoundError(input_vcf_fn)
        with _open_maybe_gz(input_vcf_fn) as f:
            for row in f:
                if row.startswith("#"):
                    continue
                cols = row.rstrip("\n").split("\t")
                ctg, pos = cols[0], int(cols[1])
                if ctg_name is not None and ctg != ctg_name:
                    continue
                try:
                    qual = float(cols[5])
                except ValueError:
                    qual = 0.0
                if min_qual is not None and qual < min_qual:
                    continue
                if input_filter_tag is not None and len(cols) > 6 \
                        and cols[6] != input_filter_tag:
                    continue
                key = (ctg, pos)
                fmt = cols[8].split(":") if len(cols) > 8 else []
                sample = dict(zip(fmt, cols[9].split(":"))) \
                    if len(cols) > 9 else {}
                dp = int(sample["DP"]) if sample.get("DP", ".").isdigit() else None
                if min_coverage is not None and dp is not None \
                        and dp < min_coverage:
                    low_confident.add(key)
                    continue
                if min_coverage is not None and min_alt_coverage is not None \
                        and "AD" in sample:
                    alt_ads = sample["AD"].split(",")[1:]
                    if any(ad.isdigit() and int(ad) < min_alt_coverage
                           for ad in alt_ads):
                        low_confident.add(key)
                        continue
                qual_of[key] = qual

    counts = {c: HappyClassCounts()
              for c in ("Overall", "SNP", "INDEL", "INS", "DEL")}
    snp_fp_qual, snp_tp_qual = {}, {}
    snp_fn_keys, snp_tp_keys = set(), set()
    n_filtered = 0

    with _open_maybe_gz(happy_vcf_fn) as f:
        for row in f:
            if row.startswith("#"):
                continue
            cols = row.rstrip("\n").split("\t")
            ctg, pos = cols[0], int(cols[1])
            if ctg_name is not None and ctg != ctg_name:
                continue
            key = (ctg, pos)
            if key in low_confident:
                continue
            # truths-support re-filter (coverage / alt support / AF),
            # src/calculate_overall_metrics.py:214-233
            info = truths_support.get(key) if truths_support else None
            if info is not None:
                cov, ad_list, af_list = info
                if min_coverage is not None and cov < min_coverage:
                    n_filtered += 1
                    continue
                fail = False
                for ad, af in zip(ad_list, af_list):
                    if min_alt_coverage is not None and ad < min_alt_coverage:
                        fail = True
                        break
                    if min_af is not None and af < min_af:
                        fail = True
                        break
                if fail:
                    n_filtered += 1
                    continue

            fmt = cols[8].split(":")
            truth = cols[9].split(":")
            query = cols[10].split(":")
            if "UNK" in truth and "UNK" in query:
                continue
            ft = dict(zip(fmt, truth))
            fq = dict(zip(fmt, query))
            required = ("BD", "BI", "BVT", "GT", "BK")
            if any(not ft.get(k) for k in required) \
                    or any(not fq.get(k) for k in required):
                raise ValueError(
                    "hap.py format mismatch: BD/BI/BVT/GT/BK required in both "
                    "TRUTH and QUERY samples (row %s:%d)" % (ctg, pos))

            query_fp = fq["BD"] == "FP"
            query_tp = fq["BD"] == "TP"
            truth_fn = ft["BD"] == "FN"
            truth_tp = ft["BD"] == "TP"
            if skip_genotyping and fq["BK"] == "am" and ft["BK"] == "am" \
                    and ft["BD"] != "UNK" and fq["BD"] != "UNK":
                # allele match with only a zygosity mismatch -> promoted to TP
                query_fp, query_tp, truth_fn, truth_tp = False, True, False, True

            def tally(cls, q_match, t_match):
                c = counts[cls]
                c.query_fp += 1 if (q_match and query_fp) else 0
                c.query_tp += 1 if (q_match and query_tp) else 0
                c.truth_fn += 1 if (t_match and truth_fn) else 0
                c.truth_tp += 1 if (t_match and truth_tp) else 0

            q_snp, t_snp = fq["BVT"] == "SNP", ft["BVT"] == "SNP"
            q_indel, t_indel = fq["BVT"] == "INDEL", ft["BVT"] == "INDEL"
            tally("SNP", q_snp, t_snp)
            tally("INDEL", q_indel, t_indel)
            tally("INS", q_indel and fq["BI"][:1] == "i",
                  t_indel and ft["BI"][:1] == "i")
            tally("DEL", q_indel and fq["BI"][:1] == "d",
                  t_indel and ft["BI"][:1] == "d")

            if q_snp and query_fp:
                snp_fp_qual[key] = float(qual_of.get(key, 0.0))
            if q_snp and query_tp:
                snp_tp_qual[key] = float(qual_of.get(key, 0.0))
            if t_snp and truth_fn:
                snp_fn_keys.add(key)
            if t_snp and truth_tp:
                snp_tp_keys.add(key)

    overall = counts["Overall"]
    overall.query_fp = counts["SNP"].query_fp + counts["INDEL"].query_fp
    overall.query_tp = counts["SNP"].query_tp + counts["INDEL"].query_tp
    overall.truth_fn = counts["SNP"].truth_fn + counts["INDEL"].truth_fn
    overall.truth_tp = counts["SNP"].truth_tp + counts["INDEL"].truth_tp
    sweep_inputs = (snp_fp_qual, snp_tp_qual, len(snp_fn_keys),
                    len(snp_tp_keys))
    return counts, sweep_inputs


def best_f1_sweep(fp_qual_dict, tp_qual_dict, fn_count, truth_tp_count,
                  use_int_cut_off=True):
    """Qual-cutoff sweep over SNV TP/FP quals, sorted best F1 first
    (src/calculate_overall_metrics.py:81-99)."""
    if use_int_cut_off:
        quals = sorted({int(q) for q in list(fp_qual_dict.values())
                        + list(tp_qual_dict.values())})
    else:
        quals = [i / 100.0 for i in range(0, 101)]
    results = []
    for qual in quals:
        fp = sum(1 for v in fp_qual_dict.values() if v >= qual)
        tp = sum(1 for v in tp_qual_dict.values() if v >= qual)
        fn = fn_count + len(tp_qual_dict) - tp
        pass_tp = truth_tp_count - (len(tp_qual_dict) - tp)
        pre, rec, f1 = metrics_from_counts(fp, tp, fn, pass_tp)
        results.append([qual, pre, rec, f1, tp, fp, fn, tp + fn])
    results.sort(key=lambda r: r[3], reverse=True)
    return results


def format_happy_table(counts, sweep=None):
    """The reference's ljust(20) metric table text
    (src/calculate_overall_metrics.py:350-361)."""
    lines = ["".join(h.ljust(20) for h in (
        "VariantType", "TRUTH.FP", "TRUTH.FN", "TRUTH.TP", "QUERY.TP",
        "METRIC.Precision", "METRIC.Recall", "METRIC.F1_Score"))]
    for cls in ("Overall", "SNP", "INDEL", "INS", "DEL"):
        c = counts[cls]
        p, r, f1 = c.metrics()
        lines.append("".join(str(v).ljust(20) for v in (
            cls, c.query_fp, c.truth_fn, c.truth_tp, c.query_tp, p, r, f1)))
    if sweep:
        best = list(sweep[0])
        best[0] = "SNV(Best F1)"
        lines.append("".join(
            str(v).ljust(13) if i >= 4 or i == 0 else ("%.4f" % v).ljust(13)
            for i, v in enumerate(best)))
    return "\n".join(lines)
