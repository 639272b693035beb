"""The port's evaluation toolkit held to the JAX package: the same inputs
through both packages' functions and CLI subcommands give equal outputs
(mirrors tests/test_toolkit.py, tests/test_happy_metrics.py:142,151 and
tests/test_tsv_interop.py:90). The tools that build pileups run on the
port's host count backend and on the count kernel's dispatch
(CLAIR3_RNA_TORCH_PILEUP_BACKEND=kernel, the plain version on the CPU)
with equal outputs.
"""

import dataclasses
import os
import random

import pytest
import torch

# one intra-op thread: the suite runs six worker processes on a
# shared host, where PyTorch's spinning thread pools oversubscribe it
torch.set_num_threads(1)


def _write_truth(path, variants, contig="chr1"):
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER"
                "\tINFO\tFORMAT\tS\n")
        for v in variants[contig]:
            gt = "1/1" if v.genotype == (1, 1) else "0/1"
            f.write(f"{contig}\t{v.pos + 1}\t.\t{v.ref}\t{v.alt}\t60\tPASS\t."
                    f"\tGT\t{gt}\n")
    return path


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Seed 62: chr1 5 kb, 10 variants, depth 25, reads with HP tags; its
    truth VCF."""
    from clair3_rna_torch import simdata

    d = tmp_path_factory.mktemp("toolkit")
    fasta, bam, _, variants = simdata.make_dataset(
        d, seed=62, contig_len=5000, n_variants=10, depth=25, with_hp=True)
    truth = _write_truth(str(d / "truth.vcf"), variants)
    return {"dir": d, "fasta": fasta, "bam": bam, "variants": variants,
            "truth": truth}


def _modules(name):
    import importlib
    return (importlib.import_module(f"clair3_rna_torch.{name}"),
            importlib.import_module(f"clair3_rna_tpu.{name}"))


@pytest.mark.parametrize("with_hp", [False, True])
def test_truth_site_support_and_filtering(data, tmp_path, with_hp):
    """Per-truth-site coverage and allele support (with and without the HP
    breakdown), the truths file and the truth filter equal the JAX
    package's (as tests/test_toolkit.py:20,144)."""
    taf, jaf = _modules("evaluation.af_distribution")
    ttf, jtf = _modules("evaluation.truth_filter")
    got = taf.truth_site_support(data["bam"], data["fasta"], data["truth"],
                                 with_hp=with_hp, device="cpu")
    want = jaf.truth_site_support(data["bam"], data["fasta"], data["truth"],
                                  with_hp=with_hp)
    assert got == want
    assert len(got) == len(data["variants"]["chr1"])
    t_fn = taf.write_truths_file(got, str(tmp_path / "t_truths"))
    j_fn = jaf.write_truths_file(want, str(tmp_path / "j_truths"))
    assert open(t_fn).read() == open(j_fn).read()
    support = taf.load_truths_file(t_fn)
    assert support == jaf.load_truths_file(j_fn)
    kept, dropped = ttf.find_low_confident_variants(data["truth"], support)
    assert (kept, dropped) == jtf.find_low_confident_variants(
        data["truth"], support)
    out_t = ttf.write_filtered_truth(data["truth"], kept,
                                     str(tmp_path / "t.vcf"))
    out_j = jtf.write_filtered_truth(data["truth"], kept,
                                     str(tmp_path / "j.vcf"))
    assert open(out_t).read() == open(out_j).read()


def test_stratified_metrics(data, tmp_path):
    """Coverage/AF-stratified P/R/F1 of a called VCF against the truth
    (as tests/test_toolkit.py:49)."""
    from clair3_rna_torch.caller.decode import CallConfig
    from clair3_rna_torch.caller.pipeline import run_calling
    from clair3_rna_torch.config import PileupConfig

    taf, jaf = _modules("evaluation.af_distribution")
    tom, jom = _modules("evaluation.overall_metrics")
    calls = str(tmp_path / "calls.vcf")
    run_calling(data["bam"], data["fasta"], calls,
                cfg=PileupConfig(batch_size=64), call_cfg=CallConfig(),
                compress=False, progress=False, device="cpu")
    truths_fn = taf.write_truths_file(
        taf.truth_site_support(data["bam"], data["fasta"], data["truth"],
                               device="cpu"), str(tmp_path / "truths"))
    kw = dict(min_coverage=4, min_alt_coverage=2, skip_genotyping=True)
    got = tom.stratified_metrics(
        calls, data["truth"], truths_support=taf.load_truths_file(truths_fn),
        **kw)
    want = jom.stratified_metrics(
        calls, data["truth"], truths_support=jaf.load_truths_file(truths_fn),
        **kw)
    assert got and [dataclasses.astuple(r) for r in got] \
        == [dataclasses.astuple(r) for r in want]
    assert 0.0 <= got[0].f1 <= 1.0


def test_editing_site_discovery(tmp_path):
    """A-to-G silver editing sites, with and without a DNA BAM (as
    tests/test_toolkit.py:70)."""
    from clair3_rna_torch import simdata
    from clair3_rna_torch.io.fasta import write_fasta

    tse, jse = _modules("evaluation.silver_editing")
    rng = random.Random(3)
    genome = simdata.random_genome(rng, [("chr1", 3000)])
    seq = list(genome["chr1"])
    seq[1500] = "A"
    genome["chr1"] = "".join(seq)
    variants = {"chr1": [simdata.Variant(1500, "A", "G", (1, 1))]}
    fasta, bam = str(tmp_path / "r.fa"), str(tmp_path / "r.bam")
    write_fasta(fasta, genome)
    simdata.simulate_bam(bam, genome, variants, rng, depth=40)
    got = tse.find_editing_sites(bam, fasta, rna_min_af=0.75, device="cpu")
    assert got == jse.find_editing_sites(bam, fasta, rna_min_af=0.75)
    assert ("chr1", 1501) in {(c, p) for c, p, *_ in got}
    # the same BAM as the DNA: the site is in the DNA too, so it is dropped
    got = tse.find_editing_sites(bam, fasta, dna_bam_path=bam, device="cpu")
    assert got == jse.find_editing_sites(bam, fasta, dna_bam_path=bam)
    assert ("chr1", 1501) not in {(c, p) for c, p, *_ in got}


def test_add_back_and_concat(data, tmp_path):
    """Genotyping add-back of uncalled sites and concat_files (as
    tests/test_toolkit.py:90)."""
    tgt, jgt = _modules("postprocess.genotyping")
    tcc, jcc = _modules("postprocess.concat")
    v0 = data["variants"]["chr1"][0]
    call_path = str(tmp_path / "calls.vcf")
    with open(call_path, "w") as f:
        f.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER"
                "\tINFO\tFORMAT\tS\n")
        f.write(f"chr1\t{v0.pos + 1}\t.\t{v0.ref}\t{v0.alt}\t20.00\tPASS\t.\t"
                f"GT:GQ:DP:AD:AF\t0/1:20:30:15,15:0.5000\n")
    outs = {}
    for name, mod, kw in (("port", tgt, {"device": "cpu"}), ("jax", jgt, {})):
        out, n_added = mod.add_back_missing_variants(
            call_path, data["truth"], data["bam"], data["fasta"],
            str(tmp_path / f"{name}.vcf"), **kw)
        outs[name] = (open(out).read(), n_added)
    assert outs["port"] == outs["jax"]
    assert outs["port"][1] == len(data["variants"]["chr1"]) - 1

    d = tmp_path / "parts"
    d.mkdir()
    (d / "part_a.txt").write_text("#h\n1\n")
    (d / "part_b.txt").write_text("#h\n2\n")
    for keep in (False, True):
        t_out, t_n = tcc.concat_files(str(d), str(tmp_path / "t.txt"),
                                      prefix="part_",
                                      skip_header_after_first=not keep)
        j_out, j_n = jcc.concat_files(str(d), str(tmp_path / "j.txt"),
                                      prefix="part_",
                                      skip_header_after_first=not keep)
        assert t_n == j_n == 2
        assert open(t_out).read() == open(j_out).read()


def test_paired_af_distribution(data, tmp_path):
    """Tumor/normal per-site support, both sides and one-sided (as
    tests/test_toolkit.py:123)."""
    taf, jaf = _modules("evaluation.af_distribution")
    for normal, tumor in ((data["bam"], data["bam"]), (data["bam"], None)):
        got = taf.paired_site_support(normal, tumor, data["fasta"],
                                      data["truth"], device="cpu")
        assert got and got == jaf.paired_site_support(
            normal, tumor, data["fasta"], data["truth"])
    t = taf.write_paired_file(got, str(tmp_path / "t"))
    j = jaf.write_paired_file(got, str(tmp_path / "j"))
    assert open(t).read() == open(j).read()


def test_compare_vcf_roc_and_site_dumps(tmp_path, capsys):
    """compare_vcf through both CLIs: the report, the --roc_fn table and
    the --output_dir per-class VCFs are equal (as
    tests/test_toolkit.py:165), and --best_f1 picks the same cutoff."""
    from clair3_rna_torch.cli import main as tmain
    from clair3_rna_tpu.cli import main as jmain

    header = ("##fileformat=VCFv4.2\n"
              "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n")
    call_fn, truth_fn = str(tmp_path / "calls.vcf"), str(tmp_path / "t.vcf")
    with open(call_fn, "w") as f:
        f.write(header)
        f.write("chr1\t100\t.\tA\tG\t30.0\tPASS\t.\tGT\t0/1\n")
        f.write("chr1\t200\t.\tC\tT\t5.0\tPASS\t.\tGT\t0/1\n")
        f.write("chr1\t300\t.\tG\tA\t12.0\tPASS\t.\tGT\t1/1\n")
        f.write("chr1\t500\t.\tGTT\tG\t9.0\tPASS\t.\tGT\t0/1\n")
    with open(truth_fn, "w") as f:
        f.write(header)
        f.write("chr1\t100\t.\tA\tG\t60\tPASS\t.\tGT\t0/1\n")
        f.write("chr1\t300\t.\tG\tA\t60\tPASS\t.\tGT\t0/1\n")
        f.write("chr1\t400\t.\tT\tC\t60\tPASS\t.\tGT\t0/1\n")
        f.write("chr1\t500\t.\tGTT\tG\t60\tPASS\t.\tGT\t0/1\n")
    got = {}
    for name, main in (("port", tmain), ("jax", jmain)):
        roc, dumps = str(tmp_path / f"{name}.roc"), tmp_path / name
        main(["compare_vcf", "--vcf_fn", call_fn, "--truth_vcf_fn",
              truth_fn, "--roc_fn", roc, "--output_dir", str(dumps)])
        main(["compare_vcf", "--vcf_fn", call_fn, "--truth_vcf_fn",
              truth_fn, "--best_f1", "--skip_genotyping"])
        report = capsys.readouterr().out.replace(str(tmp_path / name), "")
        report = report.replace(roc, "")
        got[name] = (report, open(roc).read(),
                     {fn: open(dumps / fn).read()
                      for fn in sorted(os.listdir(dumps))})
    assert got["port"] == got["jax"]
    assert "Overall" in got["port"][0] and "F1=" in got["port"][0]
    assert set(got["port"][2]) == {"fp.vcf", "fn.vcf", "fp_fn.vcf",
                                   "tp.vcf"}


@pytest.mark.parametrize("skip_genotyping,use_filters",
                         [(False, False), (True, False), (True, True)])
def test_happy_table_matches_jax(tmp_path, skip_genotyping, use_filters):
    """The hap.py-annotated VCF pathway: stratified counts and the best-F1
    table equal the JAX package's (as tests/test_happy_metrics.py:142,151),
    through the functions and the calculate_overall_metrics subcommand."""
    from clair3_rna_torch.cli import main as tmain
    from clair3_rna_tpu.cli import main as jmain
    from tests.test_happy_metrics import _write_fixture

    tom, jom = _modules("evaluation.overall_metrics")
    taf, jaf = _modules("evaluation.af_distribution")
    happy_fn, truths_fn, input_fn = _write_fixture(tmp_path)
    tables = []
    for om, af in ((tom, taf), (jom, jaf)):
        counts, sweep_inputs = om.happy_metrics(
            happy_fn,
            truths_support=af.load_truths_file(truths_fn)
            if use_filters else None,
            input_vcf_fn=input_fn if use_filters else None,
            min_coverage=4 if use_filters else None,
            min_alt_coverage=2 if use_filters else None,
            min_af=0.1 if use_filters else None,
            skip_genotyping=skip_genotyping)
        tables.append(om.format_happy_table(
            counts, om.best_f1_sweep(*sweep_inputs)))
    assert tables[0] == tables[1]
    if not use_filters:
        counts, _ = tom.happy_metrics(happy_fn,
                                      skip_genotyping=skip_genotyping)
        snp = counts["SNP"]
        assert (snp.query_tp, snp.query_fp, snp.truth_fn) == \
            ((4, 2, 1) if skip_genotyping else (3, 3, 2))
    outs = []
    for name, main in (("port", tmain), ("jax", jmain)):
        out = str(tmp_path / f"{name}.txt")
        args = ["calculate_overall_metrics", "--happy_vcf_fn", happy_fn,
                "--output_fn", out, "--output_best_f1_score"]
        if skip_genotyping:
            args.append("--skip_genotyping")
        if use_filters:
            args += ["--truths_fn", truths_fn, "--vcf_fn", input_fn,
                     "--min_coverage", "4", "--min_alt_coverage", "2",
                     "--min_af", "0.1"]
        main(args)
        outs.append(open(out).read())
    assert outs[0] == outs[1] == tables[0] + "\n"


def test_toolkit_subcommands(data, tmp_path):
    """The toolkit through the CLI dispatcher (as
    tests/test_tsv_interop.py:90): cal_truth_vcf_af_distribution (with
    --with_hp), get_truth_from_af, cal_af_distribution,
    call_silver_editing_site, add_back_missing_variants_in_genotyping,
    get_rna_bed and concat_files write the same files as the JAX
    package's."""
    from clair3_rna_torch.cli import main as tmain
    from clair3_rna_tpu.cli import main as jmain

    b, r, t = data["bam"], data["fasta"], data["truth"]
    frag_dir = tmp_path / "frags"
    frag_dir.mkdir()
    (frag_dir / "part_a.vcf").write_text("#h\nrow1\n")
    (frag_dir / "part_b.vcf").write_text("#h\nrow2\n")
    files = {}
    for name, main, dev in (("port", tmain, ["--device", "cpu"]),
                            ("jax", jmain, [])):
        d = tmp_path / name
        d.mkdir()
        main(["cal_truth_vcf_af_distribution", "--bam_fn", b, "--ref_fn", r,
              "--truth_vcf_fn", t, "--output_fn", str(d / "truths"),
              "--with_hp", *dev])
        main(["get_truth_from_af", "--truth_vcf_fn", t, "--truths_fn",
              str(d / "truths"), "--output_fn", str(d / "filtered.vcf")])
        main(["cal_af_distribution", "--normal_bam_fn", b, "--tumor_bam_fn",
              b, "--ref_fn", r, "--truth_vcf_fn", t, "--output_fn",
              str(d / "paired"), *dev])
        main(["call_silver_editing_site", "--bam_fn", b, "--ref_fn", r,
              "--output_fn", str(d / "editing.tsv"), "--rna_min_af", "0.3",
              *dev])
        main(["add_back_missing_variants_in_genotyping", "--vcf_fn",
              str(d / "filtered.vcf"), "--sites_vcf_fn", t, "--bam_fn", b,
              "--ref_fn", r, "--output_fn", str(d / "added.vcf"), *dev])
        main(["get_rna_bed", "--bam_fn", b, "--output_fn",
              str(d / "rna.bed")])
        main(["concat_files", "--input_dir", str(frag_dir), "--output_fn",
              str(d / "cat.vcf"), "--prefix", "part_"])
        files[name] = {fn: open(d / fn).read() for fn in sorted(os.listdir(d))}
    assert files["port"] == files["jax"]
    assert files["port"]["cat.vcf"] == "#h\nrow1\nrow2\n"
    assert all(files["port"].values())


def test_af_distribution_on_the_count_kernel_dispatch(data, tmp_path,
                                                      monkeypatch):
    """cal_af_distribution on the pure-array builder with its counts through
    the count kernel's dispatch (CLAIR3_RNA_TORCH_PILEUP_BACKEND=kernel;
    its plain version on CPU tensors) writes the host backend's bytes, and
    reaches the dispatch; without --device cpu it needs a card, while the
    host backend touches no device."""
    from clair3_rna_torch.cli import main
    from clair3_rna_torch.ops import pileup_kernel as tpk

    backends = []
    orig = tpk.pileup_counts

    def counting(*a, **k):
        backends.append(a[4])
        return orig(*a, **k)

    monkeypatch.setattr(tpk, "pileup_counts", counting)
    monkeypatch.setenv("CLAIR3_RNA_TORCH_NO_NATIVE", "1")
    args = ["cal_af_distribution", "--normal_bam_fn", data["bam"],
            "--ref_fn", data["fasta"], "--truth_vcf_fn", data["truth"]]
    out = {}
    for backend in ("host", "kernel"):
        monkeypatch.setenv("CLAIR3_RNA_TORCH_PILEUP_BACKEND", backend)
        out[backend] = str(tmp_path / backend)
        main(args + ["--output_fn", out[backend], "--device", "cpu"])
    assert open(out["host"], "rb").read() == open(out["kernel"], "rb").read()
    assert backends and set(backends) == {"kernel"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(args + ["--output_fn", str(tmp_path / "x")])
        monkeypatch.setenv("CLAIR3_RNA_TORCH_PILEUP_BACKEND", "host")
        main(args + ["--output_fn", str(tmp_path / "y")])
        assert open(tmp_path / "y").read() == open(out["host"]).read()
