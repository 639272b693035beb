"""The port's phasing package (clair3_rna_torch.phasing) against the JAX
package's (clair3_rna_tpu.phasing) on the same seeded inputs: phase and
block arrays, read alleles, het-site selection, read haplotypes, switch
error and the HP-tagged BAM must be equal, tolerance 0. Also the
tests/test_phasing.py checks, run on the port: the union-find triangle,
the switch-error metric, switch error against planted truth, and the
external-phaser orchestration with its golden argv.
"""

import os
import random
import stat
import subprocess
import sys

import numpy as np
import pytest

from clair3_rna_torch import simdata
from clair3_rna_torch.phasing import phase as tph
from clair3_rna_torch.phasing import pipeline as tpp

# the JAX package is imported inside the tests, so that the file collects
# where only PyTorch is installed (the card's `-m cuda` run)


def _jax_phasing():
    from clair3_rna_tpu.phasing import phase, pipeline
    return phase, pipeline


VCF_HEADER = ("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
              "FILTER\tINFO\tFORMAT\tS\n")


def _random_reads_alleles(seed, n_sites=60, n_reads=400, span=12,
                          noise=0.08):
    """Reads covering runs of consecutive sites, alleles from two planted
    haplotypes with `noise` flipped; some reads see no site. Few reads
    and much noise give many equal-weight edges that disagree, where the
    phasers' tie order decides."""
    rng = np.random.default_rng(seed)
    truth = rng.integers(0, 2, n_sites)
    reads = []
    for _ in range(n_reads):
        lo = int(rng.integers(0, n_sites))
        hi = min(n_sites, lo + int(rng.integers(0, span)))
        hap = int(rng.integers(0, 2))
        alleles = []
        for i in range(lo, hi):
            if rng.random() < 0.2:
                continue  # site not informative in this read
            a = int(truth[i]) ^ hap
            if rng.random() < noise:
                a ^= 1
            alleles.append((i, a))
        reads.append(alleles)
    return reads, n_sites


@pytest.mark.parametrize("seed,min_link,n_reads,noise", [
    (1, 2, 400, 0.08), (2, 1, 400, 0.08), (3, 3, 400, 0.08),
    (4, 1, 80, 0.35), (5, 2, 120, 0.3)])
def test_phase_sites_match_jax(seed, min_link, n_reads, noise):
    jph, _ = _jax_phasing()
    reads, n = _random_reads_alleles(seed, n_reads=n_reads, noise=noise)
    for fn in ("phase_sites", "phase_sites_pairwise"):
        jp, jb = getattr(jph, fn)(reads, n, min_link=min_link)
        tp, tb = getattr(tph, fn)(reads, n, min_link=min_link)
        assert np.array_equal(jp, tp) and jp.dtype == tp.dtype, fn
        assert np.array_equal(jb, tb) and jb.dtype == tb.dtype, fn
    phase, block = tph.phase_sites_pairwise(reads, n, min_link=min_link)
    for min_votes in (1, 3):
        assert (tph.assign_read_haplotypes(reads, phase, block, min_votes)
                == jph.assign_read_haplotypes(reads, phase, block,
                                              min_votes))


def test_pairwise_unionfind_orients_simple_triangle():
    """tests/test_phasing.py:22 on the port: the long-range pair orients
    site 2 although its adjacent link is below min_link."""
    jph, _ = _jax_phasing()
    reads = ([[(0, 0), (1, 1)]] * 5 + [[(0, 1), (2, 1)]] * 5
             + [[(1, 1), (2, 0)]] * 1)
    phase, block = tph.phase_sites_pairwise(reads, 3, min_link=2)
    assert list(block) == [0, 0, 0]
    assert list(phase) == [0, 1, 0]
    _, block_adj = tph.phase_sites(reads, 3, min_link=2)
    assert block_adj[2] != block_adj[1]
    for fn in ("phase_sites", "phase_sites_pairwise"):
        for got, want in zip(getattr(tph, fn)(reads, 3, min_link=2),
                             getattr(jph, fn)(reads, 3, min_link=2)):
            assert np.array_equal(got, want)


def test_switch_error_rate_metric():
    """tests/test_phasing.py:42 on the port, and equal to the JAX
    package's on random phasings."""
    jph, _ = _jax_phasing()
    phase = np.array([0, 1, 1, 0], np.int8)
    block = np.array([0, 0, 0, 0], np.int64)
    truth = np.array([0, 1, 0, 1], np.int8)
    ser, n = tph.switch_error_rate(phase, block, truth)
    assert n == 3 and abs(ser - 1 / 3) < 1e-9
    assert tph.switch_error_rate(1 - phase, block, 1 - truth)[0] == ser
    assert tph.switch_error_rate(phase, np.arange(4), truth) == (0.0, 0)
    rng = np.random.default_rng(5)
    for _ in range(20):
        p = rng.integers(0, 2, 50).astype(np.int8)
        b = np.sort(rng.integers(0, 6, 50))
        t = rng.integers(0, 2, 50).astype(np.int8)
        assert (tph.switch_error_rate(p, b, t)
                == jph.switch_error_rate(p, b, t))


@pytest.fixture(scope="module")
def hp_dataset(tmp_path_factory):
    """tests/test_phasing.py:56's dataset: chr1 60 kb, 150 SNVs with the
    alt on either haplotype, depth 30, reads carrying their true HP; plus a
    first-pass-like VCF of every planted variant and some rows that
    het_snvs_from_vcf must skip."""
    from clair3_rna_torch.io.fasta import write_fasta

    tmp = tmp_path_factory.mktemp("torch_phasing")
    rng = random.Random(17)
    genome = simdata.random_genome(rng, [("chr1", 60_000)])
    variants = simdata.plant_variants(rng, genome, n_per_contig=150,
                                      indel_fraction=0.0,
                                      het_genotypes=((0, 1), (1, 0)))
    bam = str(tmp / "reads.bam")
    simdata.simulate_bam(bam, genome, variants, rng, depth=30, with_hp=True)
    ref = str(tmp / "ref.fa")
    write_fasta(ref, genome)
    vcf = str(tmp / "calls.vcf")
    with open(vcf, "w") as f:
        f.write(VCF_HEADER)
        for i, v in enumerate(variants["chr1"]):
            gt = {(1, 1): "1/1", (0, 1): "0/1", (1, 0): "1|0"}[v.genotype]
            qual = 5 if i % 11 == 0 else 30
            f.write(f"chr1\t{v.pos + 1}\t.\t{v.ref}\t{v.alt}\t{qual}\tPASS"
                    f"\t.\tGT\t{gt}\n")
        f.write("chr1\t101\t.\tA\tC,G\t30\tPASS\t.\tGT\t1/2\n")
        f.write("chr1\t201\t.\tAT\tA\t30\tPASS\t.\tGT\t0/1\n")
        f.write("chr2\t301\t.\tA\tC\t30\tPASS\t.\tGT\t0/1\n")
    return genome, variants, bam, ref, vcf


def _alleles_of(pkg_phase, reader_cls, bam, sites):
    positions = np.array([s.pos for s in sites], np.int64)
    lookup = {s.pos: i for i, s in enumerate(sites)}
    usable = [r for r in reader_cls(bam).fetch("chr1")
              if not (r.flag & 2316)]
    return usable, [pkg_phase.read_alleles(r, positions, lookup, sites)
                    for r in usable]


def test_phasing_matches_jax_vs_truth(hp_dataset):
    """tests/test_phasing.py:68 on the port -- switch error and haplotag
    accuracy against the planted truth -- with het_snvs_from_vcf,
    read_alleles, both phasers, assign_read_haplotypes and
    switch_error_rate equal to the JAX package's."""
    jph, _ = _jax_phasing()
    from clair3_rna_torch.io.bam import BamReader as TBam
    from clair3_rna_torch.io.vcf import VcfReader as TVcf
    from clair3_rna_tpu.io.bam import BamReader as JBam
    from clair3_rna_tpu.io.vcf import VcfReader as JVcf

    _, variants, bam, _, vcf = hp_dataset
    for min_qual in (None, 20):
        got = tph.het_snvs_from_vcf(TVcf(vcf, show_ref=False), "chr1",
                                    min_qual=min_qual)
        want = jph.het_snvs_from_vcf(JVcf(vcf, show_ref=False), "chr1",
                                     min_qual=min_qual)
        assert [vars(s) for s in got] == [vars(s) for s in want]
    sites = tph.het_snvs_from_vcf(TVcf(vcf, show_ref=False), "chr1")
    het = [v for v in variants["chr1"] if sorted(v.genotype) == [0, 1]]
    assert [s.pos for s in sites] == [v.pos for v in het]
    truth_phase = np.array([v.genotype.index(1) for v in het], np.int8)

    usable, alleles = _alleles_of(tph, TBam, bam, sites)
    _, jalleles = _alleles_of(jph, JBam, bam, sites)
    assert alleles == jalleles
    results = {}
    for fn in ("phase_sites", "phase_sites_pairwise"):
        phase, block = getattr(tph, fn)(alleles, len(sites))
        jphase, jblock = getattr(jph, fn)(alleles, len(sites))
        assert np.array_equal(phase, jphase)
        assert np.array_equal(block, jblock)
        ser = tph.switch_error_rate(phase, block, truth_phase)
        assert ser == jph.switch_error_rate(phase, block, truth_phase)
        results[fn] = (phase, block, ser)
    pw_phase, pw_block, (pw_ser, pw_pairs) = results["phase_sites_pairwise"]
    _, adj_block, (adj_ser, _) = results["phase_sites"]
    assert pw_pairs > 50
    assert pw_ser <= adj_ser + 1e-9
    assert pw_ser < 0.05, f"pairwise switch error too high: {pw_ser:.3f}"
    assert len(set(pw_block.tolist())) <= len(set(adj_block.tolist()))

    hp = tph.assign_read_haplotypes(alleles, pw_phase, pw_block)
    assert hp == jph.assign_read_haplotypes(alleles, pw_phase, pw_block)
    by_block = {}
    for rec, one, h in zip(usable, alleles, hp):
        if h and one:
            by_block.setdefault(pw_block[one[0][0]], []).append(
                (h, rec.tags["HP"]))
    n_ok = n_all = 0
    for pairs in by_block.values():
        agree = sum(1 for h, t in pairs if h == t)
        n_ok += max(agree, len(pairs) - agree)
        n_all += len(pairs)
    assert n_all > len(usable) // 2, "too few reads haplotagged"
    assert n_ok / n_all > 0.95, f"haplotag accuracy {n_ok / n_all:.3f}"


def _records(reader_cls, path):
    reader = reader_cls(path)
    return [(r.name, r.flag, ctg, r.pos, r.mapq, list(map(tuple, r.cigar)),
             r.seq, bytes(r.qual) if r.qual is not None else None,
             dict(r.tags))
            for ctg in reader.references for r in reader.fetch(ctg)]


def test_phase_and_haplotag_matches_jax(hp_dataset, tmp_path):
    """The tagged BAM's record stream (name, flag, pos, mapq, cigar, seq,
    qual, tags with HP), read back through both packages' BamReader,
    equals the JAX package's; so do the files' bytes."""
    _, jpp = _jax_phasing()
    from clair3_rna_torch.io.bam import BamReader as TBam
    from clair3_rna_tpu.io.bam import BamReader as JBam

    _, _, bam, ref, vcf = hp_dataset
    # the reads' simulated HP tags are replaced by the phaser's
    got, want = str(tmp_path / "torch.bam"), str(tmp_path / "jax.bam")
    assert tpp.phase_and_haplotag(bam, ref, vcf, got) == got
    jpp.phase_and_haplotag(bam, ref, vcf, want)
    recs = _records(TBam, got)
    assert recs == _records(JBam, got) == _records(TBam, want)
    assert recs == _records(JBam, want)
    assert len(recs) == len(_records(TBam, bam))
    n_hp = sum(r[-1].get("HP", 0) in (1, 2) for r in recs)
    assert n_hp > len(recs) // 2
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read(), "tagged BAM bytes differ"


def test_external_phaser_orchestration(hp_dataset, tmp_path):
    """tests/test_phasing.py:147 on the port: --phaser whatshap runs a stub
    executable that logs its argv and copies its inputs; a missing tool
    raises FileNotFoundError."""
    from clair3_rna_torch.io.bam import BamReader

    _, _, bam, ref, vcf = hp_dataset
    log = str(tmp_path / "calls.log")
    stub = str(tmp_path / "whatshap")
    with open(stub, "w") as f:
        f.write(f"""#!{sys.executable}
import shutil, sys
with open({log!r}, "a") as lf:
    lf.write(" ".join(sys.argv[1:]) + "\\n")
args = sys.argv[1:]
out = args[args.index("--output") + 1]
shutil.copyfile(args[-2] if args[0] == "phase" else args[-1], out)
""")
    os.chmod(stub, os.stat(stub).st_mode | stat.S_IEXEC)
    # the staged inputs land beside the output BAM
    out_bam = str(tmp_path / "tagged.bam")
    assert tpp.phase_and_haplotag(bam, ref, vcf, out_bam, phaser="whatshap",
                                  whatshap=stub) == out_bam
    calls = open(log).read().splitlines()
    assert len(calls) == 2
    assert calls[0].startswith("phase ") and "--distrust-genotypes" in calls[0]
    assert calls[1].startswith("haplotag ") \
        and "--ignore-read-groups" in calls[1]
    assert len(list(BamReader(out_bam).fetch("chr1"))) > 0
    assert os.path.exists(out_bam + ".bai")
    with pytest.raises(FileNotFoundError, match="longphase not found"):
        tpp.phase_and_haplotag(bam, ref, vcf, out_bam, phaser="longphase",
                               longphase=str(tmp_path / "nope"))
    with pytest.raises(ValueError, match="unknown phaser"):
        tpp.phase_and_haplotag(bam, ref, vcf, out_bam, phaser="other")


@pytest.mark.parametrize("tool,platform", [
    ("whatshap", "ont_dorado_drna004"),
    ("longphase", "ont_dorado_drna004"),
    ("longphase", "hifi_sequel2"),
])
def test_external_phaser_golden_argv(tmp_path, monkeypatch, tool, platform):
    """tests/test_phasing.py:276 on the port: the whatshap/longphase argv
    string for string, with subprocess.run replaced; the JAX package's
    phase_and_haplotag, run the same way, makes the same calls."""
    _, jpp = _jax_phasing()
    wd = str(tmp_path)
    vcf = os.path.join(wd, "calls.vcf")
    with open(vcf, "w") as f:
        f.write(VCF_HEADER + "chr1\t100\t.\tA\tC\t30\tPASS\t.\tGT\t0/1\n")
    bam = os.path.join(wd, "reads.bam")
    ref = os.path.join(wd, "ref.fa")
    out_bam = os.path.join(wd, "tagged.bam")
    phased_prefix = os.path.join(wd, "external_phased")
    vcf_gz = os.path.join(wd, "phase_input.vcf.gz")
    calls = []

    def fake_run(cmd, check=True, **kw):
        calls.append(list(cmd))
        if cmd[0].endswith("longphase") and cmd[1] == "phase":
            with open(phased_prefix + ".vcf", "w") as f:
                f.write(VCF_HEADER)
        return subprocess.CompletedProcess(cmd, 0)

    real_exists = os.path.exists
    monkeypatch.setattr(os.path, "exists",
                        lambda p: True if p.endswith(tool)
                        else real_exists(p))
    monkeypatch.setattr(subprocess, "run", fake_run)
    runs = {}
    for name, pkg in (("torch", tpp), ("jax", jpp)):
        calls.clear()
        pkg.phase_and_haplotag(bam, ref, vcf, out_bam, phaser=tool,
                               whatshap="/tools/bin/whatshap",
                               longphase="/tools/bin/longphase",
                               platform=platform)
        runs[name] = list(calls)
    if tool == "whatshap":
        want = [
            ["/tools/bin/whatshap", "phase", "--output",
             phased_prefix + ".vcf.gz", "--reference", ref,
             "--distrust-genotypes", "--ignore-read-groups", vcf_gz, bam],
            ["/tools/bin/whatshap", "haplotag", "--output", out_bam,
             "--reference", ref, "--ignore-read-groups",
             phased_prefix + ".vcf.gz", bam],
        ]
    else:
        plat_flag = "--ont" if platform.startswith("ont") else "--pb"
        want = [
            ["/tools/bin/longphase", "phase", "-s", vcf_gz, "-b", bam, "-r",
             ref, plat_flag, "-o", phased_prefix],
            ["/tools/bin/longphase", "haplotag", "-s",
             phased_prefix + ".vcf.gz", "-b", bam, "-r", ref, "-o",
             os.path.splitext(out_bam)[0]],
        ]
    assert runs["torch"] == want
    assert runs["jax"] == want
