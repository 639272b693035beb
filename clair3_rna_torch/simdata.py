"""Synthetic genome / long-read RNA data generator for tests and benchmarks.

The repo ships no demo data, so tests and chip_smoke.py simulate ONT-like
spliced RNA reads over a random genome, inject germline variants, and write
real BAM/FASTA files through the package's own writers. A copy of
tests/simdata.py: the same seed gives the same files.
"""

import dataclasses
import random

from clair3_rna_torch.io.bam import (
    BamRecord, BamWriter, CIGAR_M, CIGAR_I, CIGAR_D, CIGAR_N, CIGAR_S,
    FLAG_REVERSE,
)
from clair3_rna_torch.io.fasta import write_fasta

BASES = "ACGT"


@dataclasses.dataclass
class Variant:
    pos: int          # 0-based
    ref: str
    alt: str
    genotype: tuple   # e.g. (0, 1) or (1, 1)

    @property
    def is_snp(self):
        return len(self.ref) == 1 and len(self.alt) == 1


def random_genome(rng, contigs):
    return {name: "".join(rng.choice(BASES) for _ in range(length))
            for name, length in contigs}


def plant_variants(rng, genome, n_per_contig=8, indel_fraction=0.3, region=None,
                   het_genotypes=((0, 1),)):
    """Choose germline variants (SNPs + short indels) per contig.

    het_genotypes lists the heterozygous phasings to draw from; pass
    ((0, 1), (1, 0)) for phasing tests where the alt allele must land on
    either haplotype (the default keeps historical datasets stable)."""
    variants = {}
    for name, seq in genome.items():
        lo, hi = region if region else (50, len(seq) - 50)
        chosen = {}
        occupied_bins = {}  # pos//40 -> [positions]; O(1) proximity check,
        attempts = 0        # identical accept/reject to the linear scan
        while len(chosen) < n_per_contig and attempts < 10 * n_per_contig:
            attempts += 1
            pos = rng.randrange(lo, hi)
            pbin = pos // 40
            if any(abs(pos - p) < 40
                   for nb in (pbin - 1, pbin, pbin + 1)
                   for p in occupied_bins.get(nb, ())):
                continue
            ref_base = seq[pos]
            genotype = rng.choice(list(het_genotypes) + [(1, 1)])
            r = rng.random()
            if r > indel_fraction:
                alt = rng.choice([b for b in BASES if b != ref_base])
                chosen[pos] = Variant(pos, ref_base, alt, genotype)
            elif r > indel_fraction / 2:
                ins = "".join(rng.choice(BASES) for _ in range(rng.randrange(1, 4)))
                chosen[pos] = Variant(pos, ref_base, ref_base + ins, genotype)
            else:
                dlen = rng.randrange(1, 4)
                if pos + 1 + dlen >= len(seq):
                    continue
                chosen[pos] = Variant(pos, seq[pos:pos + 1 + dlen], ref_base, genotype)
            occupied_bins.setdefault(pbin, []).append(pos)
        variants[name] = sorted(chosen.values(), key=lambda v: v.pos)
    return variants


def _apply_haplotype(seq, variants, haplotype):
    """Apply the variants carried by one haplotype to a contig sequence.

    Returns (hap_seq, mapping) where mapping aligns hap coordinates back to
    reference coordinates implicitly via per-variant offsets; we instead
    simulate reads directly on the reference with variant substitution, so
    this helper only returns the variant subset carried.
    """
    return [v for v in variants if v.genotype[haplotype] == 1]


def simulate_read(rng, ref_seq, contig_variants, start, end, error_rate=0.02,
                  splice=None, haplotype=None):
    """Simulate one spliced read covering [start, end) on the reference.

    Returns (pos, cigar, seq) built segment by segment; `splice` is an
    optional list of (intron_start, intron_end) within [start, end).
    """
    if haplotype is None:
        haplotype = rng.randrange(2)
    if isinstance(contig_variants, dict):  # pre-indexed {pos: v} per hap
        carried = contig_variants
    else:
        carried = {v.pos: v for v in contig_variants
                   if v.genotype[haplotype] == 1}

    introns = sorted(splice or [])
    segments = []
    seg_start = start
    for istart, iend in introns:
        if istart > seg_start:
            segments.append((seg_start, istart))
        seg_start = iend
    if seg_start < end:
        segments.append((seg_start, end))

    cigar = []
    seq_parts = []
    prev_end = None
    for seg_lo, seg_hi in segments:
        if prev_end is not None:
            cigar.append((CIGAR_N, seg_lo - prev_end))
        prev_end = seg_hi
        p = seg_lo
        pending_m = 0
        while p < seg_hi:
            v = carried.get(p)
            if v is not None and len(v.ref) > 1 and p + len(v.ref) - 1 < seg_hi:
                # deletion: emit ref base then skip deleted span
                seq_parts.append(v.alt)
                pending_m += 1
                cigar.append((CIGAR_M, pending_m))
                pending_m = 0
                cigar.append((CIGAR_D, len(v.ref) - 1))
                p += len(v.ref)
            elif v is not None and len(v.alt) > 1:
                # insertion: ref base followed by the inserted bases
                seq_parts.append(v.alt)
                pending_m += 1
                cigar.append((CIGAR_M, pending_m))
                pending_m = 0
                cigar.append((CIGAR_I, len(v.alt) - 1))
                p += 1
            elif v is not None and v.is_snp:
                seq_parts.append(v.alt)
                pending_m += 1
                p += 1
            else:
                base = ref_seq[p]
                if rng.random() < error_rate:
                    base = rng.choice([b for b in BASES if b != base])
                seq_parts.append(base)
                pending_m += 1
                p += 1
        if pending_m:
            cigar.append((CIGAR_M, pending_m))

    # merge adjacent same-op cigar entries
    merged = []
    for op, length in cigar:
        if length == 0:
            continue
        if merged and merged[-1][0] == op:
            merged[-1][1] += length
        else:
            merged.append([op, length])
    return start, [(op, l) for op, l in merged], "".join(seq_parts)


def simulate_bam(path, genome, variants, rng, depth=30, read_len=400,
                 error_rate=0.02, splice_sites=None, mapq=(20, 60),
                 with_hp=False, region=None, error_rate_range=None,
                 extra_regions=None):
    """Write a coordinate-sorted BAM of simulated reads; returns read count.

    error_rate_range=(lo, hi) draws a PER-READ error rate uniformly from
    [lo, hi) instead of the uniform error_rate -- models the per-read
    quality spread of real dRNA data.

    extra_regions={name: [(lo, hi, extra_depth), ...]} adds extra_depth of
    coverage confined to [lo, hi) on top of the base depth -- models a
    high-expression transcript on a normal background. Appended after the
    base read loop so default-argument RNG streams are unchanged."""
    refs = [(name, len(seq)) for name, seq in genome.items()]
    count = 0
    with BamWriter(path, refs) as writer:
        for ref_id, (name, seq) in enumerate(genome.items()):
            contig_vars = variants.get(name, [])
            # pre-index carried variants per haplotype once per contig --
            # rebuilding the dict per read is quadratic in variant count
            carried_by_hap = [
                {v.pos: v for v in contig_vars if v.genotype[h] == 1}
                for h in (0, 1)]
            lo, hi = region if region else (0, len(seq))
            reads = []
            n_reads = max(1, depth * (hi - lo) // read_len)
            for i in range(n_reads):
                start = rng.randrange(lo, max(lo + 1, hi - read_len // 2))
                end = min(start + rng.randrange(read_len // 2, read_len * 2), hi)
                if end - start < 30:
                    continue
                splice = []
                if splice_sites:
                    for istart, iend in splice_sites.get(name, []):
                        if start < istart and iend < end:
                            splice.append((istart, iend))
                hap = rng.randrange(2)
                er = rng.uniform(*error_rate_range) if error_rate_range \
                    else error_rate
                pos, cigar, rseq = simulate_read(
                    rng, seq, carried_by_hap[hap], start, end,
                    error_rate=er, splice=splice, haplotype=hap)
                if not rseq:
                    continue
                flag = FLAG_REVERSE if rng.random() < 0.5 else 0
                tags = {"HP": hap + 1} if with_hp else {}
                qual = bytes([min(40, max(10, int(rng.gauss(25, 5))))
                              for _ in range(len(rseq))])
                reads.append(BamRecord(
                    name=f"read_{name}_{i}", flag=flag, ref_id=ref_id,
                    pos=pos, mapq=rng.randrange(*mapq), cigar=cigar,
                    seq=rseq, qual=qual, tags=tags))
            if extra_regions:
                for xlo, xhi, xdepth in extra_regions.get(name, []):
                    n_extra = max(1, xdepth * (xhi - xlo) // read_len)
                    for i in range(n_extra):
                        start = rng.randrange(xlo,
                                              max(xlo + 1, xhi - read_len // 2))
                        end = min(start + rng.randrange(read_len // 2,
                                                        read_len * 2), xhi)
                        if end - start < 30:
                            continue
                        hap = rng.randrange(2)
                        er = rng.uniform(*error_rate_range) \
                            if error_rate_range else error_rate
                        pos, cigar, rseq = simulate_read(
                            rng, seq, carried_by_hap[hap], start, end,
                            error_rate=er, splice=[], haplotype=hap)
                        if not rseq:
                            continue
                        flag = FLAG_REVERSE if rng.random() < 0.5 else 0
                        tags = {"HP": hap + 1} if with_hp else {}
                        qual = bytes([min(40, max(10, int(rng.gauss(25, 5))))
                                      for _ in range(len(rseq))])
                        reads.append(BamRecord(
                            name=f"read_{name}_x{i}", flag=flag,
                            ref_id=ref_id, pos=pos, mapq=rng.randrange(*mapq),
                            cigar=cigar, seq=rseq, qual=qual, tags=tags))
            reads.sort(key=lambda r: r.pos)
            for r in reads:
                writer.write(r)
                count += 1
    return count


def make_dataset(tmpdir, seed=7, contig_len=6000, n_variants=10, depth=35,
                 splice=False, with_hp=False):
    """Create a full synthetic dataset: fasta + bam + truth variants."""
    rng = random.Random(seed)
    genome = random_genome(rng, [("chr1", contig_len)])
    variants = plant_variants(rng, genome, n_per_contig=n_variants)
    splice_sites = None
    if splice:
        mid = contig_len // 2
        splice_sites = {"chr1": [(mid - 200, mid + 400)]}
    fasta_path = str(tmpdir / "ref.fa")
    bam_path = str(tmpdir / "reads.bam")
    write_fasta(fasta_path, genome)
    simulate_bam(bam_path, genome, variants, rng, depth=depth,
                 splice_sites=splice_sites, with_hp=with_hp)
    return fasta_path, bam_path, genome, variants
