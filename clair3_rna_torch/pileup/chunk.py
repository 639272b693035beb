"""Chunk-level tensor production: BAM region -> TensorRecords.

Replaces the reference's per-chunk `pypy create_tensor_pileup` worker process
(clair3_rna/call_var_bam.py:205-245): a chunk is the unit of data parallelism;
rows span the +-33 bp extended region exactly like the mpileup invocation
(src/create_tensor_pileup.py:411-418). Duplicate boundary candidates are
deduplicated at the merge stage, as in the reference; under head/tail,
candidates come from the chunk core [start, end) only, as on the fused
route, since a halo candidate's window is cut at the data edge there.
"""

from dataclasses import dataclass

import numpy as np

from clair3_rna_torch import config
from clair3_rna_torch.config import PileupConfig
from clair3_rna_torch.io.bam import BamReader
from clair3_rna_torch.io.fasta import FastaFile
from clair3_rna_torch.pileup import builder
from clair3_rna_torch.pileup.events import extract_events

_CODE = np.full(256, -1, dtype=np.int8)
for _i, _b in enumerate("ACGT"):
    _CODE[ord(_b)] = _i


@dataclass
class ChunkTask:
    ctg_name: str
    start: int      # 0-based inclusive chunk start
    end: int        # 0-based exclusive chunk end


def plan_chunks(fasta: FastaFile, contigs=None, chunk_size=config.CHUNK_SIZE):
    """Contig x chunk grid (run_clair3_rna:360-381 equivalents, 0-based)."""
    tasks = []
    for name in (contigs or fasta.contigs):
        length = fasta.contig_length(name)
        n_chunks = max(1, -(-length // chunk_size))
        per = length // n_chunks + (1 if length % n_chunks else 0)
        for i in range(n_chunks):
            tasks.append(ChunkTask(name, per * i, min(per * (i + 1), length)))
    return tasks


def tasks_for_chunk_args(fasta: FastaFile, bam, ctg_name=None, chunk_id=None,
                         chunk_num=None):
    """ChunkTasks from the reference's per-worker addressing: 1-based
    --chunk_id of --chunk_num equal slices per contig
    (src/create_tensor_pileup.py:356-360), whole contig(s) otherwise."""
    contigs = [ctg_name] if ctg_name else \
        [c for c in fasta.contigs if c in bam.ref_index]
    tasks = []
    for ctg in contigs:
        length = fasta.contig_length(ctg)
        if chunk_id is not None:
            n = chunk_num or max(1, -(-length // config.CHUNK_SIZE))
            per = length // n + (1 if length % n else 0)
            lo = per * (chunk_id - 1)
            tasks.append(ChunkTask(ctg, lo, min(lo + per, length)))
        else:
            tasks.append(ChunkTask(ctg, 0, length))
    return tasks


def ref_codes_from(seq: str) -> np.ndarray:
    return _CODE[np.frombuffer(seq.encode(), dtype=np.uint8)]


def extract_region_events(bam, contig, start, end, cfg: PileupConfig):
    """Dispatch event extraction: native (C++) source or pure-Python reader."""
    if hasattr(bam, "extract_events"):  # NativeBam
        return bam.extract_events(contig, start, end, min_mq=cfg.min_mq,
                                  min_bq=cfg.min_bq,
                                  exclude_flags=cfg.exclude_flags)
    records_iter = bam.fetch(contig, start, end,
                             exclude_flags=cfg.exclude_flags,
                             min_mapq=cfg.min_mq)
    return extract_events(records_iter, start, end, min_bq=cfg.min_bq)


def _bai_exists(path: str) -> bool:
    import os
    stem, dot, _ = path.rpartition(".")
    return os.path.exists(path + ".bai") or (dot == "."
                                             and os.path.exists(stem + ".bai"))


def open_bam(path: str, prefer_native: bool = True):
    """Open a BAM with the native decoder when available.

    An unindexed BAM gets a .bai built on open (one streaming native pass,
    like `samtools index`): without one, region fetches require the whole
    decompressed file resident (a whole-genome dRNA BAM is GBs -- the
    scale_run proof measured 23.6 GB RSS on a 1.3 GB BAM before this), while
    indexed mode inflates only the BGZF blocks each region covers. If the
    directory is unwritable or the BAM is not coordinate-sorted, falls back
    to the in-memory full load with a warning.

    CLAIR3_RNA_TORCH_NO_NATIVE=1 forces the pure-Python/array path (whose
    channel accumulation backend is then selectable via
    CLAIR3_RNA_TORCH_PILEUP_BACKEND=host|device|kernel, see pileup/builder.py).
    """
    import logging
    import os
    if os.environ.get("CLAIR3_RNA_TORCH_NO_NATIVE"):
        prefer_native = False
    if prefer_native:
        try:
            from clair3_rna_torch.native import NativeBam, native_available
            if native_available():
                if not _bai_exists(path):
                    try:
                        from clair3_rna_torch.io.bai import build_index
                        build_index(path)
                    except Exception as exc:
                        logging.getLogger(__name__).warning(
                            "no .bai for %s and building one failed (%s): "
                            "falling back to whole-file in-memory load",
                            path, exc)
                return NativeBam(path)
        except Exception:
            pass
    return BamReader(path)


def build_chunk_tensors(bam: BamReader, fasta: FastaFile, task: ChunkTask,
                        cfg: PileupConfig, known_positions=None,
                        bed_regions=None, return_features=False,
                        device=None):
    """Produce TensorRecords for one chunk (the reference pipeline's unit of
    work). Returns records ordered by center position.

    `device` is where the pure-array builder takes its channel counts when
    CLAIR3_RNA_TORCH_PILEUP_BACKEND is device or kernel (the native tile
    builder and the host backend ignore it).

    bed_regions restricts calling like the reference's --bed_fn: pileup rows
    exist only within bed +-33 (split_extend_bed + mpileup -l,
    run_clair3_rna:268-296) and candidates must overlap the bed accounting
    for their deletion span (src/create_tensor_pileup.py:551-554).
    """
    window = config.NO_OF_POSITIONS
    contig_len = fasta.contig_length(task.ctg_name)
    # mpileup rows cover the +-33 extended region; clamp to contig
    row_lo = max(0, task.start - window)
    row_hi = min(contig_len, task.end + window)
    ref_lo = max(0, task.start - config.EXPAND_REFERENCE_REGION)
    ref_hi = min(contig_len, task.end + config.EXPAND_REFERENCE_REGION)
    ref_seq = fasta.fetch(task.ctg_name, ref_lo, ref_hi)

    codes = ref_codes_from(ref_seq[row_lo - ref_lo: row_hi - ref_lo])
    fin = None
    if hasattr(bam, "build_tile"):
        # native fast path: dense channel image, per-position feature
        # derivation, candidate mask, and ref-channel negation all in C++
        tile, indels, fin = bam.build_tile(task.ctg_name, row_lo, row_hi,
                                           cfg, ref_codes=codes)
        feat = builder.TileFeatures(
            start=row_lo, end=row_hi, counts=tile["counts"],
            depth=fin["depth"], covered=fin["covered"],
            group_count=tile["group_count"], group_rank=tile["group_rank"],
            ins_total=fin["ins_total"], del_total=fin["del_total"],
            star_total=fin["star_total"], alt_count=fin["alt_count"],
            ref_count=fin["ref_count"],
            max_del_length=tile["max_del_length"], max_skip=fin["max_skip"],
            ref_code=codes.astype(np.int8),
            eff_ref_code=fin["eff_ref_code"], counts_negated=True)
    else:
        indels = extract_region_events(bam, task.ctg_name, row_lo, row_hi, cfg)
        feat = builder.build_tile_features(indels, codes, cfg,
                                           device=device)

    bed_mask = None
    if bed_regions is not None:
        extended = _extend_regions(bed_regions, task.ctg_name, window)
        feat.covered &= extended.mask_for_range(task.ctg_name, row_lo, row_hi)
        positions = np.arange(row_lo, row_hi, dtype=np.int64)
        bed_mask = bed_regions.overlaps(
            task.ctg_name, positions, positions + feat.max_del_length + 2)

    if fin is not None and known_positions is None:
        # native candidate mask; re-AND with covered (bed may have clipped
        # it above) and the deletion-span bed test, as candidate_mask_from
        # would
        mask = fin["cand_mask"] & feat.covered
        if bed_mask is not None:
            mask &= bed_mask
    else:
        mask = builder.candidate_mask_from(
            feat, cfg, bed_mask=bed_mask,
            known_positions=np.asarray(known_positions, dtype=np.int64)
            if known_positions is not None else None,
        )
    # under head/tail, candidates are emitted over the chunk core only: a
    # halo candidate's window would be cut at this chunk's data edge, and
    # its row would overwrite the neighbouring chunk's at the merge. Without
    # head/tail a halo candidate passes the flank checks only when its whole
    # window lies in this chunk's data, so its row equals the neighbour's
    # and the merge drops the duplicate (per-chunk outputs keep the
    # reference's halo rows)
    core = (task.start, task.end) if cfg.enable_head_tail else (None, None)
    records = builder.build_tensors(
        indels, feat, cfg, task.ctg_name, ref_seq, ref_lo, mask,
        emit_lo=core[0], emit_hi=core[1],
    )
    if return_features:
        return records, feat, ref_seq, ref_lo
    return records


def gvcf_site_arrays(feat, task: ChunkTask, ref_seq: str, ref_lo: int):
    """Per-site (pos_1based, ref, n_total, n_ref) for GVCF accumulation over
    the chunk core [start, end): n_total/n_ref come from the pileup groups
    (ACGT+I+D, stars excluded), matching the reference's pileup_list sums
    (src/create_tensor_pileup.py:539-549)."""
    core_lo = task.start - feat.start
    core_hi = task.end - feat.start
    idx = np.nonzero(feat.covered[core_lo:core_hi])[0] + core_lo
    if len(idx) == 0:
        return None
    n_total = feat.group_count[idx].sum(axis=1)
    eff = feat.eff_ref_code[idx].astype(np.int64)
    n_ref = np.take_along_axis(feat.group_count[idx, :4], eff[:, None], axis=1)[:, 0]
    # positions whose true ref is not ACGT contribute ref 'N'
    positions = idx + feat.start + 1
    refs = [ref_seq[p - 1 - ref_lo] if feat.ref_code[i] >= 0 else "N"
            for i, p in zip(idx, positions)]
    # mpileup-depth-0 rows (skip-only coverage) report n_total = 0
    depth0 = feat.depth[idx] == 0
    n_total = np.where(depth0, 0, n_total)
    n_ref = np.where(depth0, 0, n_ref)
    return positions, refs, n_total, n_ref


def _extend_regions(bed_regions, ctg_name, pad):
    """bed +-pad, mirroring split_extend_bed (run_clair3_rna:268-296)."""
    from clair3_rna_torch.io.bed import BedRegions
    if ctg_name not in bed_regions.starts:
        return BedRegions({ctg_name: []})
    intervals = [(max(0, int(s) - pad), int(e) + pad)
                 for s, e in zip(bed_regions.starts[ctg_name],
                                 bed_regions.ends[ctg_name])]
    return BedRegions({ctg_name: intervals})
