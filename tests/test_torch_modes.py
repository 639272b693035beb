"""`call`'s modes on the port, held to the JAX package: the port's host and
fused routes (`--device cpu`) against the JAX package's host route, on the
same dataset and npz weights, through each package's CLI or run_calling.
VCF bodies must be identical. Mirrors tests/test_gvcf.py,
tests/test_cli_driver.py, tests/test_fused_pileup.py and
tests/test_chunk_resume.py.

The one intended difference is head/tail halo rows: under head/tail the
port emits each chunk's candidates over its core only, on both routes, so
its host route equals the JAX package's fused route at any chunk size; the
JAX host route emits a left-halo candidate whose window is cut at the
chunk's data edge (chr1:19980 on the seed-41 dataset at 10 kb chunks).
"""

import json
import os
import random

import pytest
import torch

# one intra-op thread: the suite runs six worker processes on a
# shared host, where PyTorch's spinning thread pools oversubscribe it
torch.set_num_threads(1)

CHUNK = "10000"


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Seed 41: chr1 30 kb, 100 variants, depth 30, a 14-16 kb splice; the
    port's init_params(0) as npz for both packages; native threads 1."""
    from clair3_rna_torch import simdata
    from clair3_rna_torch.io.fasta import write_fasta
    from clair3_rna_torch.models.network import init_params
    from clair3_rna_torch.models.params_io import save_params

    d = tmp_path_factory.mktemp("modes")
    rng = random.Random(41)
    genome = simdata.random_genome(rng, [("chr1", 30_000)])
    variants = simdata.plant_variants(rng, genome, n_per_contig=100)
    fasta, bam = str(d / "ref.fa"), str(d / "reads.bam")
    write_fasta(fasta, genome)
    simdata.simulate_bam(bam, genome, variants, rng, depth=30,
                         splice_sites={"chr1": [(14_000, 16_000)]})
    weights = save_params(str(d / "w.npz"), init_params(0, device="cpu"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CLAIR3_RNA_TORCH_NATIVE_THREADS", "1")
        mp.setenv("CLAIR3_RNA_TPU_NATIVE_THREADS", "1")
        mp.delenv("CLAIR3_RNA_TORCH_PILEUP_BACKEND", raising=False)
        mp.delenv("CLAIR3_RNA_TPU_PILEUP_BACKEND", raising=False)
        yield {"dir": d, "fasta": fasta, "bam": bam, "weights": weights,
               "variants": variants, "jax": {}}


def _body(path):
    return [line for line in open(path) if not line.startswith("#")]


def _common(data, out):
    return ["call", "-B", data["bam"], "-R", data["fasta"], "-o", out,
            "--model_path", data["weights"], "--include_all_ctgs",
            "--no_compress", "--chunk_size", CHUNK]


def _jax_cli(data, args, backend="host"):
    """The JAX package's `call` (host route unless asked), cached per
    argument list within the module: {file name: body}."""
    key = (backend,) + tuple(args)
    if key not in data["jax"]:
        from clair3_rna_tpu.cli import main

        out = str(data["dir"] / f"jax_{len(data['jax'])}")
        main(_common(data, out) + ["--pileup_backend", backend] + list(args))
        data["jax"][key] = {fn: _body(os.path.join(out, fn))
                            for fn in os.listdir(out) if fn.endswith(".vcf")}
    return data["jax"][key]


def _port_cli(data, out, backend, args):
    from clair3_rna_torch.cli import main

    outputs, stats = main(_common(data, str(out)) + [
        "--device", "cpu", "--pileup_backend", backend] + list(args))
    return {os.path.basename(p): _body(p) for p in outputs}, stats


def _sites_vcf(data, path):
    """A -G site list: the planted SNPs' positions."""
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n"
                "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for v in data["variants"]["chr1"]:
            if v.is_snp:
                f.write(f"chr1\t{v.pos + 1}\t.\t{v.ref}\t{v.alt}\t60\tPASS\t"
                        ".\n")
    return path


def _mode_args(data, mode):
    d = data["dir"]
    if mode == "gvcf":
        return ["--gvcf"]
    if mode == "bed":
        bed = str(d / "regions.bed")
        with open(bed, "w") as f:
            f.write("chr1\t5000\t12000\nchr1\t20000\t24000\n")
        return ["--bed_fn", bed]
    if mode == "region":
        return ["--region", "chr1:5000-12000"]
    if mode == "genotyping":
        return ["-G", _sites_vcf(data, str(d / "sites.vcf")),
                "--output_prefix", "geno", "--remove_intermediate_dir"]
    if mode == "print_ref_calls":
        return ["--print_ref_calls"]
    if mode == "splice":
        return ["--enable_padding_in_splice_junction_regions"]
    raise AssertionError(mode)


@pytest.mark.parametrize("mode", ["gvcf", "bed", "region", "genotyping",
                                  "print_ref_calls", "splice"])
def test_call_mode_matches_jax(data, tmp_path, mode):
    """GVCF (output.vcf and output.g.vcf), --bed_fn, --region, -G with the
    genotyping alias, --output_prefix and --remove_intermediate_dir,
    --print_ref_calls and splice padding: host and fused bodies equal the
    JAX host route's (GVCF and -G keep the fused route off or gated as in
    the JAX package)."""
    args = _mode_args(data, mode)
    want = _jax_cli(data, args)
    assert all(want.values())
    for backend in ("host", "fused"):
        got, stats = _port_cli(data, tmp_path / backend, backend, args)
        assert got == want, (mode, backend)
        if mode == "genotyping":
            assert not os.path.exists(tmp_path / backend / "tmp")
            assert set(got) == {"geno.vcf"}
        if mode == "gvcf":
            assert set(got) == {"output.vcf", "output.g.vcf"}
            assert len(got["output.g.vcf"]) > len(got["output.vcf"]) > 40
        if backend == "fused" and stats.fused is not None:
            assert stats.fused["fallback_chunks"] == 0 or mode == "splice"


@pytest.mark.parametrize("splice", [False, True])
def test_head_tail_halo_rows(data, tmp_path, splice):
    """The halo fault, repaired: under
    --enable_variant_calling_at_sequence_head_and_tail at 10 kb chunks the
    port's host and fused bodies equal the JAX package's FUSED body; the
    site chr1:19980 (seed 41, 20 bp left of the chunk boundary) is the
    core chunk's ACTG -> A 0/1 row, not the next chunk's left-halo row
    ACTG -> A,GCTG 1/2 that the JAX host route emits. At one 30 kb chunk
    (no halo) the port equals the JAX host route."""
    args = ["--enable_variant_calling_at_sequence_head_and_tail"]
    if splice:
        args.append("--enable_padding_in_splice_junction_regions")
    want = _jax_cli(data, args, backend="fused")["output.vcf"]
    jax_host = _jax_cli(data, args)["output.vcf"]
    site = [r for r in want if r.split("\t")[1] == "19980"]
    assert len(site) == 1 and site[0].split("\t")[3:5] == ["ACTG", "A"]
    assert "\t0/1:0:33:1,32:" in site[0]
    halo = [r for r in jax_host if r.split("\t")[1] == "19980"]
    assert halo[0].split("\t")[4] == "A,GCTG"
    for backend in ("host", "fused"):
        got, _ = _port_cli(data, tmp_path / backend, backend, args)
        assert got["output.vcf"] == want, backend
    one = args + ["--chunk_size", "30000"]
    want_one = _jax_cli(data, one)["output.vcf"]
    assert want_one == want
    got, _ = _port_cli(data, tmp_path / "one", "host", one)
    assert got["output.vcf"] == want_one


def test_joblog_and_profile_trace(data, tmp_path, monkeypatch):
    """--joblog writes one line a chunk and CLAIR3_RNA_TORCH_PROFILE a
    torch.profiler trace, on both routes; bodies equal the JAX host's."""
    want = _jax_cli(data, [])
    for backend in ("host", "fused"):
        joblog = str(tmp_path / f"{backend}.tsv")
        prof = tmp_path / f"trace_{backend}"
        monkeypatch.setenv("CLAIR3_RNA_TORCH_PROFILE", str(prof))
        got, stats = _port_cli(data, tmp_path / backend, backend,
                               ["--joblog", joblog])
        assert got == want
        rows = open(joblog).read().splitlines()
        assert rows[0] == "contig\tstart\tend\tcandidates\tbuild_seconds"
        assert len(rows) == 4  # three 10 kb chunks
        assert sum(int(r.split("\t")[3]) for r in rows[1:]) \
            == stats.candidates > 0
        assert os.listdir(prof) == ["trace.json"]


def test_pileup_backend_flag(data, tmp_path):
    """--pileup_backend host|fused|auto through the CLI: identical bodies,
    equal to the JAX host route's; auto resolves to host."""
    from clair3_rna_torch.caller.backend import resolve_backend

    want = _jax_cli(data, [])
    assert resolve_backend("auto") == "host"
    for backend in ("host", "fused", "auto"):
        got, stats = _port_cli(data, tmp_path / backend, backend, [])
        assert got == want, backend
        assert (stats.fused is None) == (backend != "fused")


def _sim(tmp_path, seed, contig_len, n_variants, depth, splice=None,
         variants=None, **kw):
    from clair3_rna_torch import simdata
    from clair3_rna_torch.io.fasta import write_fasta

    rng = random.Random(seed)
    genome = simdata.random_genome(rng, [("chr1", contig_len)])
    if variants is None:
        variants = simdata.plant_variants(rng, genome,
                                          n_per_contig=n_variants)
    else:
        variants = variants(genome)
    fasta, bam = str(tmp_path / "ref.fa"), str(tmp_path / "reads.bam")
    write_fasta(fasta, genome)
    simdata.simulate_bam(bam, genome, variants, rng, depth=depth,
                         splice_sites={"chr1": [splice]} if splice else None,
                         **kw)
    return fasta, bam


def jax_to_numpy(tree):
    import numpy as np

    if isinstance(tree, dict):
        return {k: jax_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def _runs(fasta, bam, tmp_path, cfg_kw=None, backends=("host", "fused"),
          **kw):
    """JAX host body, then {backend: (port body, stats)} via run_calling
    on the same weights."""
    from clair3_rna_torch.caller import pipeline as tpl
    from clair3_rna_torch.caller.decode import CallConfig as TCall
    from clair3_rna_torch.config import PileupConfig as TCfg
    from clair3_rna_torch.models.params_io import params_from_numpy
    from clair3_rna_tpu.caller.decode import CallConfig
    from clair3_rna_tpu.caller.pipeline import run_calling
    from clair3_rna_tpu.config import PileupConfig
    from clair3_rna_tpu.models.network import init_params

    jp = init_params(0)
    net = params_from_numpy(jax_to_numpy(jp), device="cpu")
    run_calling(bam, fasta, str(tmp_path / "jax.vcf"),
                cfg=PileupConfig(batch_size=256, **(cfg_kw or {})),
                call_cfg=CallConfig(show_ref=True), params=jp,
                contigs=["chr1"], compress=False, progress=False,
                pileup_backend="host", **kw)
    got = {}
    for backend in backends:
        out = str(tmp_path / f"{backend}.vcf")
        _, stats = tpl.run_calling(
            bam, fasta, out, cfg=TCfg(batch_size=256, **(cfg_kw or {})),
            call_cfg=TCall(show_ref=True), params=net, contigs=["chr1"],
            compress=False, progress=False, pileup_backend=backend, **kw)
        got[backend] = (_body(out), stats)
    return _body(str(tmp_path / "jax.vcf")), got


@pytest.mark.parametrize("depth", [220, 800, 2000])
def test_renorm_depth_sweep_matches_jax(tmp_path, depth):
    """The renorm path over the AF-threshold table's depth range (as
    tests/test_fused_pileup.py:115): a 1.2 kb contig, fused rows equal to
    the JAX host route's with renorm candidates and no fallback."""
    fasta, bam = _sim(tmp_path, 46, 1_200, 5, depth)
    want, got = _runs(fasta, bam, tmp_path)
    assert len(want) > 2
    for backend, (body, _) in got.items():
        assert body == want, backend
    fused = got["fused"][1].fused
    assert fused["renorm_candidates"] > 0
    assert fused["fallback_chunks"] == 0


def test_splice_cluster_falls_back_matches_jax(tmp_path):
    """Clustered splice-trigger candidates force a whole-chunk host
    fallback, not the hatch (as tests/test_fused_pileup.py:330)."""
    from clair3_rna_torch import simdata

    def variants(genome):
        seq = genome["chr1"]
        return {"chr1": [
            simdata.Variant(p, seq[p],
                            next(b for b in "ACGT" if b != seq[p]), (0, 1))
            for p in (3_000 - 52, 3_000 - 30, 3_000 - 8)]}

    fasta, bam = _sim(tmp_path, 61, 6_000, 0, 30, splice=(3_000, 3_200),
                      variants=variants)
    want, got = _runs(fasta, bam, tmp_path,
                      cfg_kw=dict(enable_splice_padding=True))
    assert len(want) >= 3
    for backend, (body, _) in got.items():
        assert body == want, backend
    fused = got["fused"][1].fused
    assert fused["fallback_chunks"] > 0
    assert fused["hatch_candidates"] == 0


def test_overflow_retry_matches_jax(tmp_path):
    """A -G grid every 15 bp puts ~1,300 candidates in a chunk: the fused
    pass reruns once at a wider budget (as tests/test_fused_pileup.py:368)
    and its rows equal the JAX host route's."""
    fasta, bam = _sim(tmp_path, 49, 20_000, 60, 30)
    known = {"chr1": list(range(200, 19_800, 15))}
    want, got = _runs(fasta, bam, tmp_path, known_vcf_positions=known)
    assert len(want) > 1000
    for backend, (body, _) in got.items():
        assert body == want, backend
    assert got["fused"][1].fused["overflow_retries"] > 0


def _resume_run(data, out, mdir, backend, resume=False, crash_start=None,
                monkeypatch=None):
    from clair3_rna_torch.caller import pipeline as tpl
    from clair3_rna_torch.caller.decode import CallConfig
    from clair3_rna_torch.config import PileupConfig
    from clair3_rna_torch.models.network import init_params
    from clair3_rna_torch.ops import fused_pileup as tfp

    if crash_start is not None:
        if backend == "host":
            target, name, start_of = tpl, "build_chunk_tensors", \
                lambda a: a[2].start
        else:
            target, name, start_of = tfp.FusedChunkCaller, "call_chunk", \
                lambda a: a[6]
        orig = getattr(target, name)

        def crashing(*a, **k):
            if start_of(a) == crash_start:
                raise RuntimeError("injected crash")
            return orig(*a, **k)

        monkeypatch.setattr(target, name, crashing)
    try:
        tpl.run_calling(data["bam"], data["fasta"], str(out),
                        cfg=PileupConfig(batch_size=16),
                        call_cfg=CallConfig(), params=init_params(
                            0, device="cpu"), contigs=["chr1"],
                        chunk_size=int(CHUNK), compress=False,
                        progress=False, manifest_dir=str(mdir),
                        resume=resume, pileup_backend=backend)
    finally:
        if monkeypatch is not None:
            monkeypatch.undo()
    return _body(out)


@pytest.mark.parametrize("backend", ["host", "fused"])
def test_torn_tail_and_duplicate_lines_tolerated(data, tmp_path,
                                                 monkeypatch, backend):
    """A crash at the third chunk, then a duplicated complete line and a
    torn trailing line in the chunk manifest: --resume restores what is
    whole and the body equals the JAX host route's (as
    tests/test_chunk_resume.py:87; the fused route's manifest resume as
    tests/test_fused_pileup.py:386)."""
    want = _jax_cli(data, [])["output.vcf"]
    mdir = tmp_path / "m"
    with pytest.raises(RuntimeError, match="injected crash"):
        _resume_run(data, tmp_path / "crashed.vcf", mdir, backend,
                    crash_start=20_000, monkeypatch=monkeypatch)
    path = mdir / "chr1.chunks.jsonl"
    first = open(path).readline()
    assert json.loads(first)["rows"]
    with open(path, "a") as f:
        f.write(first)                      # duplicate complete line
        f.write('{"start": 20000, "end"')   # torn tail (kill mid-write)
    got = _resume_run(data, tmp_path / "resumed.vcf", mdir, backend,
                      resume=True)
    assert got == want
    assert (mdir / "chr1.done.json").exists()
    # a second resume restores the whole contig from its manifest
    again = _resume_run(data, tmp_path / "again.vcf", mdir, backend,
                        resume=True)
    assert again == want


def test_resume_without_manifests_runs_everything(data, tmp_path):
    """--resume with no manifests on disk runs every chunk (as
    tests/test_chunk_resume.py:108)."""
    want = _jax_cli(data, [])["output.vcf"]
    got = _resume_run(data, tmp_path / "fresh.vcf", tmp_path / "m", "host",
                      resume=True)
    assert got == want and len(got) > 40
