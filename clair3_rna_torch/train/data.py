"""Training data construction: candidate tensors + truth labels -> binned
shards.

Capability match for the reference's training tensor path
(src/create_training_tensor.py + the tensor2bin library half in
clair3_rna/utils.py:432-570): candidates come from the same pileup builder as
calling, labels from a truth VCF via the task label algebra, non-variant
candidates are downsampled, and shards are stored as .npz (instead of
PyTables+lz4hc). A copy of the JAX package's train/data.py: the same
np.random.RandomState(seed) draws in the same order, so the bins are that
package's bins byte for byte. `device` is where the pure-array builder
takes its channel counts (CLAIR3_RNA_TORCH_PILEUP_BACKEND=device|kernel);
the native tile builder ignores it.
"""

import logging
import os

import numpy as np

from clair3_rna_torch import config, task
from clair3_rna_torch.config import PileupConfig
from clair3_rna_torch.caller.pipeline import batch_tensors
from clair3_rna_torch.io.fasta import FastaFile
from clair3_rna_torch.io.vcf import VcfReader
from clair3_rna_torch.pileup.chunk import (build_chunk_tensors, open_bam,
                                           plan_chunks)

logger = logging.getLogger(__name__)


def label_for_candidate(rec, truth_by_pos):
    """One-hot [90] target for a candidate TensorRecord."""
    t = truth_by_pos.get((rec.ctg_name, rec.position))
    if t is None:
        center = rec.ref_seq[config.FLANKING_BASE_NUM]
        if center not in "ACGT":
            return None
        return task.label_vector_from_reference(center)
    g1, g2 = (t.genotype + (0, 0))[:2]
    if g1 < 0 or g2 < 0:
        return None
    return task.label_vector_from_truth(t.ref, t.alt, g1, g2)


def find_read_support(rec, truth_rec, min_support=2):
    """Require read support for the truth allele at a truth site (mirrors the
    bin builder's read-support filter, clair3_rna/utils.py:198-243)."""
    _, alt_info = rec.alt_info.split("-", 1) if "-" in rec.alt_info else ("", "")
    seqs = alt_info.split(" ")
    counts = dict(zip(seqs[::2], [int(x) for x in seqs[1::2]])) if alt_info else {}
    ref, alt = truth_rec.ref, truth_rec.alt
    support = 0
    for a in alt.split(","):
        if len(ref) == 1 and len(a) == 1:
            support += counts.get("X" + a, 0)
        elif len(a) > len(ref):
            support += counts.get("I" + a, 0)
        else:
            support += sum(v for k, v in counts.items()
                           if k.startswith("D") and len(k) - 1 == len(ref) - len(a))
    return support >= min_support


def build_training_bins(bam_path, ref_path, truth_vcf_path, output_dir, *,
                        cfg: PileupConfig | None = None, contigs=None,
                        chunk_size=None, non_variant_keep_fraction=0.1,
                        min_truth_support=2, shard_size=20000, seed=0,
                        device=None):
    """Produce training shards {position_matrix, label, position, alt_info}."""
    cfg = cfg or PileupConfig()
    os.makedirs(output_dir, exist_ok=True)
    fasta = FastaFile(ref_path)
    bam = open_bam(bam_path)
    truth = VcfReader(truth_vcf_path)
    truth_by_pos = {(r.ctg_name, r.pos): r for r in truth.variant_dict.values()}

    rng = np.random.RandomState(seed)
    xs, ys, positions, alt_infos = [], [], [], []
    shard_idx = 0
    n_variant = n_nonvariant = 0

    def flush():
        nonlocal shard_idx, xs, ys, positions, alt_infos
        if not xs:
            return
        order = rng.permutation(len(xs))
        path = os.path.join(output_dir, f"bin_{shard_idx:05d}.npz")
        np.savez_compressed(
            path,
            position_matrix=np.stack(xs)[order],
            label=np.asarray(ys, dtype=np.float32)[order],
            position=np.asarray(positions)[order],
            alt_info=np.asarray(alt_infos)[order])
        shard_idx += 1
        xs, ys, positions, alt_infos = [], [], [], []

    for t in plan_chunks(fasta, contigs=contigs,
                         chunk_size=chunk_size or config.CHUNK_SIZE):
        records = build_chunk_tensors(bam, fasta, t, cfg, device=device)
        if not records:
            continue
        X = batch_tensors(records, cfg)
        for i, rec in enumerate(records):
            truth_rec = truth_by_pos.get((rec.ctg_name, rec.position))
            if truth_rec is not None:
                if not find_read_support(rec, truth_rec, min_truth_support):
                    continue
                n_variant += 1
            else:
                if rng.rand() > non_variant_keep_fraction:
                    continue
                n_nonvariant += 1
            label = label_for_candidate(rec, truth_by_pos)
            if label is None:
                continue
            xs.append(X[i])
            ys.append(label)
            positions.append(f"{rec.ctg_name}:{rec.position}:{rec.ref_seq}")
            alt_infos.append(rec.alt_info)
            if len(xs) >= shard_size:
                flush()
    flush()
    logger.info("[INFO] training bins: %d variant + %d non-variant samples "
                "in %d shard(s) -> %s", n_variant, n_nonvariant, shard_idx,
                output_dir)
    return shard_idx, n_variant, n_nonvariant


def load_bins(bin_dir):
    """Concatenate all shards -> (X int32 [N,33,C], Y float32 [N,90])."""
    xs, ys = [], []
    for fn in sorted(os.listdir(bin_dir)):
        if not fn.endswith(".npz"):
            continue
        data = np.load(os.path.join(bin_dir, fn))
        xs.append(data["position_matrix"])
        ys.append(data["label"])
    if not xs:
        raise FileNotFoundError(f"no .npz shards in {bin_dir}")
    return np.concatenate(xs), np.concatenate(ys)
