"""Call-vs-truth comparison: TP/FP/FN with SNV/INS/DEL breakdown and a
best-F1 quality sweep (capability match for src/compare_vcf.py:74-555)."""

from dataclasses import dataclass, field

from clair3_rna_torch.io.bed import BedRegions
from clair3_rna_torch.io.vcf import VcfReader


def variant_type(ref: str, alt: str) -> str:
    alts = alt.split(",")
    types = set()
    for a in alts:
        if len(ref) == 1 and len(a) == 1:
            types.add("snv")
        elif len(a) > len(ref):
            types.add("ins")
        else:
            types.add("del")
    if len(types) == 1:
        return types.pop()
    return "mixed"


def normalize(ref: str, alt: str):
    """Trim shared suffix then prefix so representations compare equal."""
    alts = alt.split(",")
    while len(ref) > 1 and all(len(a) > 1 and a[-1] == ref[-1] for a in alts):
        ref = ref[:-1]
        alts = [a[:-1] for a in alts]
    return ref, ",".join(alts)


@dataclass
class Metrics:
    tp: int = 0
    fp: int = 0
    fn: int = 0

    @property
    def precision(self):
        return self.tp / (self.tp + self.fp) if self.tp + self.fp else 0.0

    @property
    def recall(self):
        return self.tp / (self.tp + self.fn) if self.tp + self.fn else 0.0

    @property
    def f1(self):
        p, r = self.precision, self.recall
        return 2 * p * r / (p + r) if p + r else 0.0

    def row(self, name):
        return (f"{name}\tTP={self.tp}\tFP={self.fp}\tFN={self.fn}\t"
                f"P={self.precision:.4f}\tR={self.recall:.4f}\tF1={self.f1:.4f}")


@dataclass
class Comparison:
    overall: Metrics = field(default_factory=Metrics)
    by_type: dict = field(default_factory=lambda: {
        "snv": Metrics(), "ins": Metrics(), "del": Metrics()})
    genotype_mismatch: int = 0
    tp_sites: list = field(default_factory=list)
    fp_sites: list = field(default_factory=list)
    fn_sites: list = field(default_factory=list)


def compare_vcf(call_fn, truth_fn, bed_fn=None, ctg_name=None, min_qual=None,
                skip_genotyping=False):
    """Match called variants against truth by (contig, pos, normalized
    ref/alt); allele match with genotype mismatch counts as TP when
    skip_genotyping (the reference README's 'zygosity disregarded' metric)."""
    calls = VcfReader(call_fn, ctg_name=ctg_name, show_ref=False,
                      min_qual=min_qual)
    truth = VcfReader(truth_fn, ctg_name=ctg_name, show_ref=False)
    bed = BedRegions.from_file(bed_fn) if bed_fn else None

    def in_bed(ctg, pos):
        if bed is None:
            return True
        return bool(bed.contains(ctg, [pos - 1])[0])

    result = Comparison()
    truth_keys = {}
    for (ctg, pos), rec in truth.variant_dict.items():
        if not in_bed(ctg, pos):
            continue
        truth_keys[(ctg, pos)] = rec

    matched = set()
    for (ctg, pos), rec in sorted(calls.variant_dict.items()):
        if not in_bed(ctg, pos):
            continue
        t = truth_keys.get((ctg, pos))
        vtype = variant_type(rec.ref, rec.alt)
        bucket = result.by_type.get(vtype, result.by_type["snv"])
        if t is None:
            result.overall.fp += 1
            bucket.fp += 1
            result.fp_sites.append((ctg, pos, rec.ref, rec.alt))
            continue
        same_alleles = normalize(rec.ref, rec.alt) == normalize(t.ref, t.alt)
        same_gt = sorted(rec.genotype) == sorted(t.genotype)
        if same_alleles and (same_gt or skip_genotyping):
            result.overall.tp += 1
            bucket.tp += 1
            matched.add((ctg, pos))
            result.tp_sites.append((ctg, pos, rec.ref, rec.alt))
            if not same_gt:
                result.genotype_mismatch += 1
        else:
            result.overall.fp += 1
            bucket.fp += 1
            result.fp_sites.append((ctg, pos, rec.ref, rec.alt))

    for (ctg, pos), t in sorted(truth_keys.items()):
        if (ctg, pos) in matched:
            continue
        result.overall.fn += 1
        vtype = variant_type(t.ref, t.alt)
        result.by_type.get(vtype, result.by_type["snv"]).fn += 1
        result.fn_sites.append((ctg, pos, t.ref, t.alt))
    return result


def best_f1_qual_sweep(call_fn, truth_fn, bed_fn=None, ctg_name=None,
                       quals=None, skip_genotyping=False):
    """Sweep QUAL cutoffs and report (best_qual, best_comparison)."""
    quals = quals if quals is not None else [0, 2, 4, 6, 8, 10, 12, 15, 20]
    best = None
    for q in quals:
        cmp_result = compare_vcf(call_fn, truth_fn, bed_fn=bed_fn,
                                 ctg_name=ctg_name, min_qual=q,
                                 skip_genotyping=skip_genotyping)
        if best is None or cmp_result.overall.f1 > best[1].overall.f1:
            best = (q, cmp_result)
    return best


def write_roc(result: Comparison, call_fn, roc_fn, ctg_name=None):
    """Qual-threshold ROC rows "qual  precision  recall  f1", one per
    distinct TP/FP qual, strongest cutoff first
    (src/compare_vcf.py:450-517; the caller-specific qual extractors there
    serve third-party somatic callers and are out of scope -- QUAL column
    only)."""
    calls = VcfReader(call_fn, ctg_name=ctg_name, show_ref=False)
    qual_of = {(r.ctg_name, r.pos): (r.qual if r.qual is not None else 0.0)
               for r in calls.variant_dict.values()}
    tp_quals = [qual_of.get((c, p), 0.0) for c, p, *_ in result.tp_sites]
    fp_quals = [qual_of.get((c, p), 0.0) for c, p, *_ in result.fp_sites]
    tp_total = len(tp_quals)
    fn_base = len(result.fn_sites)
    with open(roc_fn, "w") as f:
        for cut in sorted(set(tp_quals + fp_quals), reverse=True):
            tp = sum(1 for q in tp_quals if q >= cut)
            fp = sum(1 for q in fp_quals if q >= cut)
            fn = fn_base + (tp_total - tp)
            m = Metrics(tp=tp, fp=fp, fn=fn)
            f.write("\t".join(str(round(v, 4)) for v in
                              (cut, m.precision, m.recall, m.f1)) + "\n")
    return roc_fn


def dump_site_vcfs(result: Comparison, call_fn, truth_fn, output_dir,
                   ctg_name=None):
    """Write per-class VCFs fp.vcf / fn.vcf / fp_fn.vcf / tp.vcf with the
    original rows (src/compare_vcf.py:536-553): FP rows come from the calls,
    FN rows from the truth, fp_fn is their union."""
    import os

    os.makedirs(output_dir, exist_ok=True)
    calls = VcfReader(call_fn, ctg_name=ctg_name, show_ref=False,
                      keep_row_str=True)
    truth = VcfReader(truth_fn, ctg_name=ctg_name, show_ref=False,
                      keep_row_str=True)

    def rows_for(sites):
        out = []
        for c, p, *_ in sites:
            rec = calls.variant_dict.get((c, p)) \
                or truth.variant_dict.get((c, p))
            if rec is not None and rec.raw:
                out.append(rec.raw if rec.raw.endswith("\n")
                           else rec.raw + "\n")
        return out

    paths = {}
    fp_fn_sites = list(result.fp_sites) + list(result.fn_sites)
    for name, sites in (("fp", result.fp_sites), ("fn", result.fn_sites),
                        ("fp_fn", fp_fn_sites), ("tp", result.tp_sites)):
        path = os.path.join(output_dir, f"{name}.vcf")
        with open(path, "w") as f:
            f.writelines(rows_for(sites))
        paths[name] = path
    return paths


def print_report(result: Comparison, title="comparison"):
    print(f"[{title}]")
    print(result.overall.row("Overall"))
    for name in ("snv", "ins", "del"):
        print(result.by_type[name].row(name.upper()))
    if result.genotype_mismatch:
        print(f"allele-match-with-genotype-mismatch counted as TP: "
              f"{result.genotype_mismatch}")
