"""Phase + haplotag pipeline: first-pass VCF + BAM -> HP-tagged BAM.

Replaces `whatshap phase ... && whatshap haplotag` / `longphase phase/haplotag`
(run_clair3_rna:729-801).
"""

import logging
import os
import time

import numpy as np

from clair3_rna_torch.io.bam import BamReader, BamWriter
from clair3_rna_torch.io.vcf import VcfReader
from clair3_rna_torch.phasing.phase import (
    assign_read_haplotypes, het_snvs_from_vcf, phase_sites_pairwise,
    read_alleles,
)

logger = logging.getLogger(__name__)


def phase_and_haplotag(bam_path: str, ref_path: str, vcf_path: str,
                       output_bam_path: str, contigs=None,
                       exclude_flags=2316, min_mq=5, phaser="builtin",
                       whatshap="whatshap", longphase="longphase",
                       platform="ont"):
    """Tag reads with HP:i:1/2 from read-backed phasing of first-pass hets.

    phaser selects the engine: "builtin" (the in-framework pairwise-linkage
    phaser, default), or "whatshap"/"longphase" to delegate to an installed
    external phaser with the reference's exact invocations
    (run_clair3_rna:729-801). External mode requires the tool on PATH (or an
    explicit path via whatshap=/longphase=)."""
    if phaser in ("whatshap", "longphase"):
        return _external_phase_and_haplotag(
            bam_path, ref_path, vcf_path, output_bam_path, phaser,
            whatshap if phaser == "whatshap" else longphase, platform)
    if phaser != "builtin":
        raise ValueError(f"unknown phaser: {phaser}")
    bam = BamReader(bam_path)
    vcf = VcfReader(vcf_path, show_ref=False)
    contigs = contigs or bam.references

    refs = [(name, bam.reference_lengths[name]) for name in bam.references]
    # 4 compression threads: the BGZF re-deflate dominated the serial rewrite
    writer = BamWriter(output_bam_path, refs, header_text=bam.header_text,
                       threads=4)
    n_tagged = 0
    n_total = 0
    contig_set = set(contigs)
    # host seconds of the three stages, logged for the phased pass's cost:
    # scan (decode + het-site alleles), phase (linkage + read votes),
    # rewrite (decode + re-encode + deflate)
    secs = {"scan": 0.0, "phase": 0.0, "rewrite": 0.0}
    for ctg in bam.references:
        t0 = time.perf_counter()
        # two STREAMING passes per contig over the BAI-indexed block range:
        # pass 1 keeps only (read name, het-site alleles) -- a few bytes per
        # read -- and pass 2 rewrites records one at a time, so peak RSS is
        # bounded by one decompressed block, not a contig's records
        # (measured on the JAX package's copy of this loop:
        # tests/test_phasing.py::test_phasing_rss_bounded)
        if ctg not in contig_set:
            for rec in bam.fetch(ctg):
                writer.write(rec)
            secs["rewrite"] += time.perf_counter() - t0
            continue
        sites = het_snvs_from_vcf(vcf, ctg)
        site_positions = np.asarray([s.pos for s in sites], dtype=np.int64)
        site_lookup = {s.pos: i for i, s in enumerate(sites)}
        names, alleles_per_read = [], []
        for r in bam.fetch(ctg):
            if (r.flag & exclude_flags) or r.mapq < min_mq:
                continue
            names.append(r.name)
            alleles_per_read.append(
                read_alleles(r, site_positions, site_lookup, sites))
        t1 = time.perf_counter()
        phase, block = phase_sites_pairwise(alleles_per_read, len(sites))
        hp = assign_read_haplotypes(alleles_per_read, phase, block)
        hp_by_name = {n: h for n, h in zip(names, hp)}
        del names, alleles_per_read
        t2 = time.perf_counter()
        secs["scan"] += t1 - t0
        secs["phase"] += t2 - t1
        for rec in bam.fetch(ctg):
            h = hp_by_name.get(rec.name, 0)
            if h:
                rec.tags["HP"] = h
                n_tagged += 1
            n_total += 1
            writer.write(rec)
        secs["rewrite"] += time.perf_counter() - t2
    t0 = time.perf_counter()
    writer.close()
    secs["rewrite"] += time.perf_counter() - t0
    logger.info("[INFO] haplotagged %d/%d reads -> %s (host seconds: scan "
                "%.3f, phase %.3f, rewrite %.3f)", n_tagged, n_total,
                output_bam_path, secs["scan"], secs["phase"],
                secs["rewrite"])
    return output_bam_path


def _external_phase_and_haplotag(bam_path, ref_path, vcf_path,
                                 output_bam_path, tool_name, tool_path,
                                 platform):
    """Delegate phasing + haplotagging to whatshap or longphase, with the
    reference's flags (run_clair3_rna:729-801); our in-process bgzip/tabix
    and BAM indexing replace the external bgzip/tabix/samtools calls."""
    import shutil
    import subprocess

    if shutil.which(tool_path) is None and not os.path.exists(tool_path):
        raise FileNotFoundError(
            f"{tool_name} not found ({tool_path}); install it or use the "
            "builtin phaser")
    import os.path as _p
    workdir = _p.dirname(_p.abspath(output_bam_path))
    phased_prefix = _p.join(workdir, "external_phased")

    from clair3_rna_torch.io.vcf import compress_index_vcf
    vcf_in = vcf_path
    if not vcf_in.endswith(".gz"):
        import shutil as _sh
        staged = _p.join(workdir, "phase_input.vcf")
        _sh.copyfile(vcf_in, staged)
        vcf_in = compress_index_vcf(staged)

    if tool_name == "whatshap":
        # run_clair3_rna:739-747 / 775-783
        phased_vcf = phased_prefix + ".vcf.gz"
        subprocess.run([tool_path, "phase", "--output", phased_vcf,
                        "--reference", ref_path, "--distrust-genotypes",
                        "--ignore-read-groups", vcf_in, bam_path],
                       check=True)
        subprocess.run([tool_path, "haplotag", "--output", output_bam_path,
                        "--reference", ref_path, "--ignore-read-groups",
                        phased_vcf, bam_path], check=True)
    else:
        # run_clair3_rna:749-763 / 785-797 (longphase)
        plat_flag = "--ont" if platform.startswith("ont") else "--pb"
        subprocess.run([tool_path, "phase", "-s", vcf_in, "-b", bam_path,
                        "-r", ref_path, plat_flag, "-o", phased_prefix],
                       check=True)
        phased_vcf = compress_index_vcf(phased_prefix + ".vcf")
        subprocess.run([tool_path, "haplotag", "-s", phased_vcf,
                        "-b", bam_path, "-r", ref_path,
                        "-o", _p.splitext(output_bam_path)[0]], check=True)

    try:  # index the tagged BAM for downstream region access
        from clair3_rna_torch.native import get_library
        lib = get_library()
        if lib is not None and os.path.exists(output_bam_path):
            lib.bam_build_index(output_bam_path.encode(),
                                (output_bam_path + ".bai").encode())
    except Exception:
        pass
    logger.info("[INFO] %s haplotagging -> %s", tool_name, output_bam_path)
    return output_bam_path
