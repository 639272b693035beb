"""Phase + haplotag pipeline: first-pass VCF + BAM -> HP-tagged BAM.

Replaces `whatshap phase ... && whatshap haplotag` / `longphase phase/haplotag`
(run_clair3_rna:729-801).
"""

import contextlib
import logging
import os

import numpy as np

from clair3_rna_torch.caller import spans
from clair3_rna_torch.io.bam import BamReader, BamWriter, header_bytes
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
                       platform="ont", record=None):
    """Tag reads with HP:i:1/2 from read-backed phasing of first-pass hets.

    phaser selects the engine: "builtin" (the in-framework pairwise-linkage
    phaser, default), or "whatshap"/"longphase" to delegate to an installed
    external phaser with the reference's exact invocations
    (run_clair3_rna:729-801). External mode requires the tool on PATH (or an
    explicit path via whatshap=/longphase=).

    The builtin phaser's two passes over the BAM a contig (the scan of
    het-site alleles, the rewrite with HP tags) run in the native library
    on raw records when it loads; the Python loop over decoded records is
    the fallback (no library, CLAIR3_RNA_TORCH_NO_NATIVE set, or a record
    the native calls leave to it) and writes the same bytes.

    The stage's spans (caller/spans.py) go into `record`, a spans.Chunk
    (a fresh one where none is given): `phase` around the whole stage and,
    for the builtin phaser, inside it `phase.scan` (het sites from the VCF,
    each read's het-site alleles), `phase.link` (pairwise linkage + read
    votes) and `phase.rewrite` (tag, re-encode, deflate, the writer's close
    and the tagged BAM's index), each summed over the contigs; and its
    counters records_read, records_written, tagged_hp1, tagged_hp2,
    het_sites, phase_blocks (blocks of two or more het sites) and
    records_native (the records the native rewrite wrote; 0 on the Python
    path). `stage_totals(record)` reads them."""
    rec = record if record is not None else spans.Chunk()
    with rec, spans.span("phase"):
        if phaser in ("whatshap", "longphase"):
            return _external_phase_and_haplotag(
                bam_path, ref_path, vcf_path, output_bam_path, phaser,
                whatshap if phaser == "whatshap" else longphase, platform)
        if phaser != "builtin":
            raise ValueError(f"unknown phaser: {phaser}")
        _builtin_phase_and_haplotag(bam_path, vcf_path, output_bam_path,
                                    contigs, exclude_flags, min_mq)
    c = rec.counters
    logger.info("[INFO] haplotagged %d/%d reads -> %s (host seconds: scan "
                "%.3f, phase %.3f, rewrite %.3f)",
                c["tagged_hp1"] + c["tagged_hp2"], c["records_written"],
                output_bam_path, rec.seconds("phase.scan"),
                rec.seconds("phase.link"), rec.seconds("phase.rewrite"))
    return output_bam_path


def stage_totals(record):
    """The phase + haplotag stage's record -> {phase_s, scan_s, link_s,
    rewrite_s (span seconds), and its counters}."""
    out = {k + "_s": record.seconds(name) for k, name in (
        ("phase", "phase"), ("scan", "phase.scan"), ("link", "phase.link"),
        ("rewrite", "phase.rewrite"))}
    out.update(record.counters)
    return out


# blocks of the tagged BAM the native writer holds at once: 64 x (65,280
# bytes and their deflated copy), ~8 MB whatever the BAM's size
_WINDOW_BLOCKS = 64


def _builtin_phase_and_haplotag(bam_path, vcf_path, output_bam_path,
                                contigs, exclude_flags, min_mq):
    """The builtin phaser's body, under the caller's record: scan and
    rewrite in the native library when it loads (CLAIR3_RNA_TORCH_NO_NATIVE
    unset), else on the Python path, which also redoes the stage where the
    native calls leave a record to it (one the Python writer raises on, such
    as a B-array tag, fails there as before)."""
    from clair3_rna_torch import native

    if (not os.environ.get("CLAIR3_RNA_TORCH_NO_NATIVE")
            and native.get_library() is not None):
        try:
            return _phase_contigs(bam_path, vcf_path, output_bam_path,
                                  contigs, exclude_flags, min_mq,
                                  native_io=True)
        except native.NativeUnsupported as exc:
            logger.warning("[WARNING] %s; phase + haplotag on the Python "
                           "path", exc)
    _phase_contigs(bam_path, vcf_path, output_bam_path, contigs,
                   exclude_flags, min_mq, native_io=False)


def _phase_contigs(bam_path, vcf_path, output_bam_path, contigs,
                   exclude_flags, min_mq, native_io):
    from clair3_rna_torch import native
    from clair3_rna_torch.io.bai import build_index

    bam = BamReader(bam_path)
    vcf = VcfReader(vcf_path, show_ref=False)
    contig_set = set(contigs or bam.references)

    refs = [(name, bam.reference_lengths[name]) for name in bam.references]
    if native_io:
        writer = native.HaplotagWriter(
            output_bam_path, header_bytes(refs, bam.header_text),
            _WINDOW_BLOCKS)
    else:
        # the Python fallback deflates on 4 threads: the BGZF re-deflate
        # dominated its serial rewrite
        writer = BamWriter(output_bam_path, refs,
                           header_text=bam.header_text, threads=4)
    tagged = [0, 0, 0]  # records written, by HP (0: untagged)
    n_read = n_sites = n_blocks = 0
    rewrite = spans.span("phase.rewrite")
    try:
        for ref_id, ctg in enumerate(bam.references):
            # two STREAMING passes per contig over the BAI-indexed block
            # range: the scan keeps only (read name, het-site alleles) -- a
            # few bytes per read -- and the rewrite streams records one at a
            # time, so peak RSS is bounded by a few blocks, not a contig's
            # records (measured on the JAX package's copy of the Python
            # loop: tests/test_phasing.py::test_phasing_rss_bounded)
            ref_len = bam.reference_lengths[ctg]
            hp_by_name = {}
            if ctg in contig_set:
                with spans.span("phase.scan"):
                    sites = het_snvs_from_vcf(vcf, ctg)
                    if native_io:
                        names, alleles_per_read = native.het_scan(
                            bam_path, bam.chunks(ctg), ref_id, ref_len,
                            sites, exclude_flags, min_mq)
                    else:
                        names, alleles_per_read = _scan(
                            bam, ctg, sites, exclude_flags, min_mq)
                with spans.span("phase.link"):
                    phase, block = phase_sites_pairwise(alleles_per_read,
                                                        len(sites))
                    hp = assign_read_haplotypes(alleles_per_read, phase,
                                                block)
                    hp_by_name = {n: h for n, h in zip(names, hp)}
                    del names, alleles_per_read
                n_sites += len(sites)
                if len(sites):
                    n_blocks += int((np.bincount(block) >= 2).sum())
            with rewrite:
                if native_io:
                    n, hp1, hp2 = writer.rewrite_contig(
                        bam_path, bam.chunks(ctg), ref_id, ref_len,
                        hp_by_name)
                    n_read += n
                    tagged[0] += n - hp1 - hp2
                    tagged[1] += hp1
                    tagged[2] += hp2
                else:
                    for rec in bam.fetch(ctg):
                        n_read += 1
                        h = hp_by_name.get(rec.name, 0)
                        if h:
                            rec.tags["HP"] = h
                        writer.write(rec)
                        tagged[h] += 1
    except BaseException:
        if native_io:  # join its threads; the Python path rewrites the file
            with contextlib.suppress(OSError):
                writer.close()
        raise
    with rewrite:
        writer.close()
        # rebuilt on every rewrite: an index left by an earlier tagged BAM
        # at this path would be stale
        build_index(output_bam_path)
    spans.note(records_read=n_read, records_written=sum(tagged),
               tagged_hp1=tagged[1], tagged_hp2=tagged[2], het_sites=n_sites,
               phase_blocks=n_blocks,
               records_native=sum(tagged) if native_io else 0)


def _scan(bam, ctg, sites, exclude_flags, min_mq):
    """The Python scan of one contig: (read names, het-site alleles) of the
    reads the filter keeps."""
    site_positions = np.asarray([s.pos for s in sites], dtype=np.int64)
    site_lookup = {s.pos: i for i, s in enumerate(sites)}
    names, alleles_per_read = [], []
    for r in bam.fetch(ctg):
        if (r.flag & exclude_flags) or r.mapq < min_mq:
            continue
        names.append(r.name)
        alleles_per_read.append(
            read_alleles(r, site_positions, site_lookup, sites))
    return names, alleles_per_read


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
