"""The port's interop and post-processing subcommands, held to the JAX
package: create_tensor_pileup's TSV rows, call_variants' VCF, debug and
ensemble rows, call_var_bam per chunk with sort_vcf, and index, on the
same inputs and npz weights (mirrors tests/test_tsv_interop.py and
tests/test_cli_driver.py:168-213). The port runs with --device cpu.

Head/tail halos are the one intended difference (under head/tail the port
emits each chunk's candidates over its core only), so the mirrors stay off
head/tail and a port-only case checks that create_tensor_pileup emits no
row outside the chunk core under head/tail.
"""

import io
import os
import sys

import pytest
import torch

# one intra-op thread: the suite runs six worker processes on a
# shared host, where PyTorch's spinning thread pools oversubscribe it
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Seed 32: chr1 6 kb, 14 variants, depth 30; the port's
    init_params(0) as npz for both packages; the JAX package's tensor TSV
    of chr1."""
    from clair3_rna_torch import simdata
    from clair3_rna_torch.models.network import init_params
    from clair3_rna_torch.models.params_io import save_params
    from clair3_rna_tpu.cli import main as jmain

    d = tmp_path_factory.mktemp("interop")
    fasta, bam, _, variants = simdata.make_dataset(
        d, seed=32, contig_len=6000, n_variants=14, depth=30)
    weights = save_params(str(d / "w.npz"), init_params(0, device="cpu"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CLAIR3_RNA_TORCH_NATIVE_THREADS", "1")
        mp.setenv("CLAIR3_RNA_TPU_NATIVE_THREADS", "1")
        jax_tsv = str(d / "jax.tsv")
        jmain(["create_tensor_pileup", "--bam_fn", bam, "--ref_fn", fasta,
               "--ctgName", "chr1", "--tensor_can_fn", jax_tsv])
        yield {"dir": d, "fasta": fasta, "bam": bam, "weights": weights,
               "variants": variants, "jax_tsv": jax_tsv}


def _port(args):
    from clair3_rna_torch.cli import main
    return main(args)


def _jax(args):
    from clair3_rna_tpu.cli import main
    return main(args)


def _rows(path):
    return [line for line in open(path).read().splitlines()
            if line and not line.startswith("#")]


def _port_tsv(data, tmp_path, *extra):
    tsv = str(tmp_path / "port.tsv")
    _port(["create_tensor_pileup", "--bam_fn", data["bam"], "--ref_fn",
           data["fasta"], "--ctgName", "chr1", "--tensor_can_fn", tsv,
           "--device", "cpu", *extra])
    return tsv


def test_create_tensor_pileup_rows_match_jax(data, tmp_path):
    """Reference-format rows (chrom, pos, 33-mer, 33x18 tensor, alt info),
    byte-identical to the JAX package's."""
    tsv = _port_tsv(data, tmp_path)
    rows = open(tsv).read().splitlines()
    assert rows == open(data["jax_tsv"]).read().splitlines()
    cols = rows[0].split("\t")
    assert len(cols) == 5 and cols[0] == "chr1" and len(cols[2]) == 33
    assert len(cols[3].split()) == 33 * 18 and "-" in cols[4]


@pytest.mark.parametrize("source", ["file", "stdin", "zstd", "batch_7"])
def test_call_variants_matches_jax(data, tmp_path, monkeypatch, source):
    """call_variants on the port's TSV (from a file, stdin, a .zst file, or
    in batches of 7 rows) equals the JAX package's call_variants on its
    TSV: the port's network runs in fixed slabs, so the batch the TSV is
    read in does not move a row."""
    want_fn = str(data["dir"] / "jax_calls.vcf")
    if not os.path.exists(want_fn):
        _jax(["call_variants", "--tensor_fn", data["jax_tsv"], "--call_fn",
              want_fn, "--model_path", data["weights"], "--show_ref"])
    tsv = _port_tsv(data, tmp_path)
    args = ["call_variants", "--call_fn", str(tmp_path / "out.vcf"),
            "--chkpnt_fn", data["weights"], "--showRef", "--device", "cpu"]
    if source == "stdin":
        monkeypatch.setattr(sys, "stdin", io.StringIO(open(tsv).read()))
    elif source == "zstd":
        import zstandard

        with open(tsv, "rb") as fin, open(tsv + ".zst", "wb") as fout:
            fout.write(zstandard.ZstdCompressor().compress(fin.read()))
        args += ["--tensor_fn", tsv + ".zst"]
    else:
        args += ["--tensor_fn", tsv]
        if source == "batch_7":
            args += ["--batch_size", "7"]
    _port(args)
    got = open(tmp_path / "out.vcf").read()
    assert got == open(want_fn).read()
    assert len(got.splitlines()) > 20


def test_tsv_roundtrip_matches_call(data, tmp_path):
    """create_tensor_pileup | call_variants equals the in-process `call`
    (FILTER blanked: the merge adds LowQual), which equals the JAX
    package's `call`."""
    tsv = _port_tsv(data, tmp_path)
    piped = str(tmp_path / "piped.vcf")
    _port(["call_variants", "--tensor_fn", tsv, "--call_fn", piped,
           "--model_path", data["weights"], "--show_ref", "--device", "cpu"])
    common = ["-B", data["bam"], "-R", data["fasta"], "--model_path",
              data["weights"], "--include_all_ctgs", "--ctg_name", "chr1",
              "--print_ref_calls", "--no_compress"]
    _port(["call", "-o", str(tmp_path / "direct"), "--device", "cpu",
           *common])
    _jax(["call", "-o", str(tmp_path / "jax"), *common])

    def blank_filter(rows):
        return ["\t".join(r.split("\t")[:6] + ["."] + r.split("\t")[7:])
                for r in rows]

    direct = _rows(tmp_path / "direct" / "output.vcf")
    assert direct == _rows(tmp_path / "jax" / "output.vcf")
    assert blank_filter(_rows(piped)) == blank_filter(direct)
    assert direct


# the network's CPU tolerance against the JAX package
# (tests/test_torch_network.py), plus one unit of the 6th printed decimal
PROB_ATOL = 5e-6 + 1e-6


def _same_rows(got, want):
    """Rows equal field by field: every non-numeric token exactly, every
    printed probability within PROB_ATOL."""
    import re

    assert len(got) == len(want)
    for a, b in zip(got, want):
        ta, tb = re.split(r"[\s,\[\]']+", a), re.split(r"[\s,\[\]']+", b)
        assert len(ta) == len(tb), (a, b)
        for x, y in zip(ta, tb):
            if re.fullmatch(r"\d+\.\d{6,}", x):
                assert abs(float(x) - float(y)) <= PROB_ATOL, (a, b)
            else:
                assert x == y, (a, b)


@pytest.mark.parametrize("mode", ["debug", "ensemble"])
def test_call_variants_debug_and_ensemble_rows_match_jax(data, tmp_path,
                                                         mode):
    """--debug probability rows and --output_for_ensemble rows equal the
    JAX package's on the same TSV and weights: sites, alleles and verdicts
    exactly, the printed probabilities (6 or 8 decimals) within the
    network's tolerance, since float32 sums in two frameworks can differ
    in the last printed digit."""
    flag = "--debug" if mode == "debug" else "--output_for_ensemble"
    want, got = str(tmp_path / "jax.out"), str(tmp_path / "port.out")
    common = ["call_variants", "--tensor_fn", data["jax_tsv"],
              "--model_path", data["weights"], "--show_ref", flag]
    _jax(common + ["--call_fn", want])
    _port(common + ["--call_fn", got, "--device", "cpu"])
    lines = open(got).read().splitlines()
    assert len(lines) > 20
    _same_rows(lines, open(want).read().splitlines())
    fields = lines[0].split("\t")
    assert fields[0] == "chr1"
    if mode == "debug":
        assert fields[2].startswith("['")
        assert fields[-1] in ("Normal output", "Reference")
    else:
        assert len(fields) == 6 and len(fields[4].split()) == 21


def test_call_var_bam_chunks_and_sort_vcf_match_call(data, tmp_path):
    """call_var_bam per chunk + sort_vcf equals `call` on the port, and
    each per-chunk VCF and the merge equal the JAX package's."""
    for pkg, run in (("port", _port), ("jax", _jax)):
        chunk_dir = tmp_path / f"chunks_{pkg}"
        chunk_dir.mkdir()
        extra = ["--device", "cpu"] if pkg == "port" else []
        for chunk_id in (1, 2):
            run(["call_var_bam", "--bam_fn", data["bam"], "--ref_fn",
                 data["fasta"], "--chkpnt_fn", data["weights"], "--ctgName",
                 "chr1", "--chunk_id", str(chunk_id), "--chunk_num", "2",
                 "--showRef", "--call_fn",
                 str(chunk_dir / f"pileup_chr1_{chunk_id}.vcf"), *extra])
        run(["sort_vcf", "--input_dir", str(chunk_dir), "--output_fn",
             str(tmp_path / f"merged_{pkg}.vcf"), "--ref_fn", data["fasta"],
             "--show_ref", "--no_compress", "--qual", "8"])
    merged = _rows(tmp_path / "merged_port.vcf")
    assert merged == _rows(tmp_path / "merged_jax.vcf")
    _port(["call", "-B", data["bam"], "-R", data["fasta"], "-o",
           str(tmp_path / "out"), "--model_path", data["weights"],
           "--include_all_ctgs", "--print_ref_calls", "--chunk_size", "3000",
           "--device", "cpu", "--no_compress", "--qual", "8"])
    assert merged == _rows(tmp_path / "out" / "output.vcf")
    assert len(merged) > 20


def test_call_var_bam_region_matches_jax(data, tmp_path):
    """--ctgStart/--ctgEnd (1-based inclusive) restrict the called region;
    rows equal the JAX package's, all within the region's +-40 bp."""
    out = {}
    for pkg, run, extra in (("port", _port, ["--device", "cpu"]),
                            ("jax", _jax, [])):
        out[pkg] = str(tmp_path / f"{pkg}.vcf")
        run(["call_var_bam", "--bam_fn", data["bam"], "--ref_fn",
             data["fasta"], "--model_path", data["weights"], "--ctgName",
             "chr1", "--ctgStart", "1001", "--ctgEnd", "2000", "--show_ref",
             "--call_fn", out[pkg], *extra])
    rows = _rows(out["port"])
    assert rows and rows == _rows(out["jax"])
    assert all(960 <= int(r.split("\t")[1]) <= 2040 for r in rows)


def test_create_tensor_pileup_head_tail_core_only(data, tmp_path):
    """Port only: under head/tail, each chunk's rows lie inside its core
    [start, end) -- no left- or right-halo candidate -- and the chunks'
    rows together equal one whole-contig chunk's."""
    ht = "--enable_variant_calling_at_sequence_head_and_tail"
    whole = open(_port_tsv(data, tmp_path, ht)).read().splitlines()
    rows = []
    for chunk_id, (lo, hi) in ((1, (0, 2000)), (2, (2000, 4000)),
                               (3, (4000, 6000))):
        tsv = str(tmp_path / f"c{chunk_id}.tsv")
        _port(["create_tensor_pileup", "--bam_fn", data["bam"], "--ref_fn",
               data["fasta"], "--ctgName", "chr1", "--chunk_id",
               str(chunk_id), "--chunk_num", "3", "--tensor_can_fn", tsv,
               "--device", "cpu", ht])
        chunk = open(tsv).read().splitlines()
        assert chunk
        assert all(lo < int(r.split("\t")[1]) <= hi for r in chunk)
        rows += chunk
    assert rows == whole


def test_index_matches_jax(data, tmp_path):
    """`index` writes the same BAI bytes as the JAX package's."""
    _port(["index", data["bam"], "-o", str(tmp_path / "port.bai")])
    _jax(["index", data["bam"], "-o", str(tmp_path / "jax.bai")])
    assert open(tmp_path / "port.bai", "rb").read() \
        == open(tmp_path / "jax.bai", "rb").read()
