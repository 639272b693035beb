"""Reference-format tensor TSV interop.

The reference splits its hot path at a process boundary: `create_tensor_pileup`
streams TSV tensor rows (src/create_tensor_pileup.py:595-605) into
`call_variants` reading them from stdin (clair3_rna/utils.py:64-138). The
port's pipeline is in-process, but both halves are exposed as standalone
subcommands with the reference's exact wire format so existing pipelines can
mix components (our builder -> their caller, or their builder -> our caller)
and so tensors can be differential-debugged row by row.
"""

import io
import sys

import numpy as np

from clair3_rna_torch import config
from clair3_rna_torch.config import PileupConfig

_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


def open_tensor_stream(path):
    """Open a tensor TSV source: stdin for PIPE/-, transparent zstd
    decompression otherwise (the reference pipes every on-disk tensor file
    through `zstd -fdc`, clair3_rna/utils.py:73-75; plain text also accepted).

    Returns (text_stream, owns_stream)."""
    if path in (None, "PIPE", "-"):
        return sys.stdin, False
    f = open(path, "rb")
    magic = f.read(4)
    f.seek(0)
    if magic == _ZSTD_MAGIC:
        import zstandard
        reader = zstandard.ZstdDecompressor().stream_reader(f,
                                                            closefd=True)
        return io.TextIOWrapper(io.BufferedReader(reader)), True
    return io.TextIOWrapper(f), True


def write_tensor_rows(bam_path, ref_path, out_stream, *, cfg: PileupConfig,
                      ctg_name=None, chunk_id=None, chunk_num=None,
                      region=None, bed_regions=None, known_positions=None,
                      device=None):
    """Emit reference-format TSV rows for one contig/chunk.

    chunk_id is 1-based like the reference's --chunk_id
    (src/create_tensor_pileup.py:356-360). Candidates come from each chunk's
    core, as in `call`. `device` is where the pure-array builder takes its
    channel counts under CLAIR3_RNA_TORCH_PILEUP_BACKEND=device|kernel.
    """
    from clair3_rna_torch.io.fasta import FastaFile
    from clair3_rna_torch.pileup.chunk import (ChunkTask, build_chunk_tensors,
                                               open_bam, tasks_for_chunk_args)

    fasta = FastaFile(ref_path)
    bam = open_bam(bam_path)
    if region is not None:
        ctg, lo_hi = region
        tasks = [ChunkTask(ctg, lo_hi[0], lo_hi[1])]
    else:
        tasks = tasks_for_chunk_args(fasta, bam, ctg_name=ctg_name,
                                     chunk_id=chunk_id, chunk_num=chunk_num)

    n_rows = 0
    for task in tasks:
        records = build_chunk_tensors(
            bam, fasta, task, cfg,
            known_positions=known_positions.get(task.ctg_name)
            if known_positions else None,
            bed_regions=bed_regions, device=device)
        for rec in records:
            out_stream.write(rec.to_reference_row() + "\n")
            n_rows += 1
    return n_rows


def read_tensor_rows(in_stream, batch_size):
    """Parse reference tensor TSV into batches.

    Yields (chroms, positions, refseqs, tensors[N,33,C], alt_infos); the
    channel count (18 vs 30 phased) is auto-detected from the row length like
    the reference (clair3_rna/utils.py:115-119).
    """
    chroms, positions, refseqs, alt_infos, flat = [], [], [], [], []
    n_channels = None
    for line in in_stream:
        line = line.rstrip("\n")
        if not line:
            continue
        chrom, coord, seq, tensor_str, alt_info = line.split("\t")[:5]
        values = np.array(tensor_str.split(), dtype=np.int32)
        if n_channels is None:
            n_channels = values.size // config.NO_OF_POSITIONS
        chroms.append(chrom)
        positions.append(int(coord))
        refseqs.append(seq)
        alt_infos.append(alt_info)
        flat.append(values.reshape(config.NO_OF_POSITIONS, n_channels))
        if len(flat) == batch_size:
            yield chroms, positions, refseqs, np.stack(flat), alt_infos
            chroms, positions, refseqs, alt_infos, flat = [], [], [], [], []
    if flat:
        yield chroms, positions, refseqs, np.stack(flat), alt_infos


_BASIC_BASES = set("ACGT")


def write_ensemble_row(out_stream, chrom, position, refseq, alt_info, probs):
    """One ensemble-mode output row: raw per-class probabilities instead of a
    VCF record (clair3_rna/call_variants.py:1023-1076 batch_output_for_ensemble
    row format; center-non-ACGT rows are skipped by the caller)."""
    gt21 = " ".join("{:0.6f}".format(p) for p in probs[:21])
    genotype = " ".join("{:0.6f}".format(p) for p in probs[21:24])
    out_stream.write("\t".join([chrom, str(position), refseq, alt_info,
                                gt21, genotype]) + "\n")


def _host(out):
    """A forward's result as a numpy array (one copy from the card)."""
    if hasattr(out, "cpu"):
        return out.cpu().numpy()
    return np.asarray(out)


def call_variants_from_tsv(in_stream, out_stream, *, cfg: PileupConfig,
                           call_cfg, params, forward, ensemble=False):
    """Reference `call_variants` equivalent: tensor TSV in, VCF rows out.

    The rows go through the pipeline's wire forward, whose network runs in
    fixed row slabs (models/network.py), so a row's probabilities, and the
    VCF row, do not depend on the TSV batch it arrived in (--batch_size).
    ensemble=True emits the reference's --output_for_ensemble row format
    (probabilities per candidate, no decode, no header) instead of VCF rows.
    """
    from clair3_rna_torch.caller.decode import decode_batch
    from clair3_rna_torch.caller.pipeline import _WIRE_CODE, prescreen_mask

    max_depth = config.MAX_DEPTH_BY_PLATFORM.get(cfg.platform, config.MAX_DEPTH)
    n_rows = 0
    for chroms, positions, refseqs, X, alt_infos in read_tensor_rows(
            in_stream, cfg.batch_size):
        depths = np.array(
            [int(a.split("-", 1)[0]) if "-" in a else 0 for a in alt_infos],
            dtype=np.int64)
        renorm = np.nonzero(depths > max_depth * 1.5)[0]
        if len(renorm):
            X = X.copy()
            X[renorm] = X[renorm] / (depths[renorm, None, None] / max_depth)
        n = len(X)
        device_mask = None
        if getattr(forward, "wire", False):
            codes = _WIRE_CODE[np.frombuffer(
                "".join(refseqs).encode(), dtype=np.uint8)].reshape(n, -1)
            peak = int(np.abs(X).max()) if n else 0
            W = np.abs(X).astype(np.uint8) if peak <= 255 else \
                (X.astype(np.int16) if peak <= 32767 else X)
            out_arr = _host(forward(params, W, codes))
            probs = out_arr[:, :-1]
            device_mask = out_arr[:, -1] != 0.0
        else:
            # int16 is lossless post-renorm and halves the device transfer
            probs = _host(forward(params, X.astype(np.int16)))
        if ensemble:
            center = config.FLANKING_BASE_NUM
            for i in range(n):
                if refseqs[i][center] not in _BASIC_BASES:
                    continue
                write_ensemble_row(out_stream, chroms[i], positions[i],
                                   refseqs[i], alt_infos[i], probs[i])
                n_rows += 1
            continue
        if device_mask is not None:
            mask = np.ones(n, dtype=bool) if call_cfg.show_ref else device_mask
        else:
            mask = prescreen_mask(probs, refseqs, call_cfg.show_ref)
        idx = np.nonzero(mask)[0]
        rows = decode_batch([chroms[i] for i in idx],
                            [positions[i] for i in idx],
                            [refseqs[i] for i in idx],
                            [alt_infos[i] for i in idx],
                            probs[idx], call_cfg)
        for row in rows:
            out_stream.write(row + "\n")
        n_rows += len(rows)
    return n_rows


def open_maybe_stdout(path):
    if path in (None, "PIPE", "-"):
        return sys.stdout, False
    return open(path, "w"), True
