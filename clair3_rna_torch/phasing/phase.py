"""Adjacent-linkage read-backed phasing (longphase-style, simplified).

Algorithm: for each contig, take heterozygous SNVs from the first-pass VCF,
derive each read's allele at each site, chain consecutive informative sites by
majority cis/trans linkage into phase blocks, then assign each read to
haplotype 1/2 by majority vote over its phased sites. This is the same
problem whatshap/longphase solve for the reference's phasing pass; exactness
of the external tool is not required -- the phasing model consumes per-
haplotype counts and tolerates local switch errors.
"""

from dataclasses import dataclass

import numpy as np

from clair3_rna_torch.io.bam import CIGAR_M, CIGAR_I, CIGAR_D, CIGAR_N, CIGAR_S, CIGAR_EQ, CIGAR_X


@dataclass
class HetSite:
    pos: int      # 0-based
    ref: str
    alt: str
    phase: int = 0       # 0: alt on hap1; 1: alt on hap2 (relative in block)
    block: int = -1


def het_snvs_from_vcf(vcf_reader, ctg_name, min_qual=None):
    """Pick phasable heterozygous SNVs (0/1, single-base ref/alt)."""
    sites = []
    for (ctg, pos), rec in vcf_reader.variant_dict.items():
        if ctg != ctg_name:
            continue
        if len(rec.ref) != 1 or "," in rec.alt or len(rec.alt) != 1:
            continue
        if sorted(rec.genotype) != [0, 1]:
            continue
        if min_qual is not None and (rec.qual is None or rec.qual < min_qual):
            continue
        sites.append(HetSite(pos=pos - 1, ref=rec.ref, alt=rec.alt))
    sites.sort(key=lambda s: s.pos)
    return sites


def read_alleles(rec, site_positions, site_lookup, sites):
    """Yield (site_index, allele) for one read; allele 0=ref, 1=alt."""
    qpos = 0
    rpos = rec.pos
    out = []
    for op, length in rec.cigar:
        if op in (CIGAR_M, CIGAR_EQ, CIGAR_X):
            lo = np.searchsorted(site_positions, rpos)
            hi = np.searchsorted(site_positions, rpos + length)
            for si in range(lo, hi):
                base = rec.seq[qpos + (site_positions[si] - rpos)].upper()
                site = sites[si]
                if base == site.alt:
                    out.append((si, 1))
                elif base == site.ref:
                    out.append((si, 0))
            qpos += length
            rpos += length
        elif op in (CIGAR_D, CIGAR_N):
            rpos += length
        elif op in (CIGAR_I, CIGAR_S):
            qpos += length
    return out


def phase_sites(reads_alleles, n_sites, min_link=2):
    """Chain sites into phase blocks by majority cis/trans linkage.

    reads_alleles: list of [(site_idx, allele), ...] per read.
    Returns (phase[n_sites], block[n_sites]).
    """
    # pairwise linkage between consecutive (by index) sites observed together
    cis = np.zeros(n_sites, dtype=np.int64)    # link between i and i+1
    trans = np.zeros(n_sites, dtype=np.int64)
    for alleles in reads_alleles:
        for (i, ai), (j, aj) in zip(alleles, alleles[1:]):
            if j == i + 1:
                if ai == aj:
                    cis[i] += 1
                else:
                    trans[i] += 1

    phase = np.zeros(n_sites, dtype=np.int8)
    block = np.zeros(n_sites, dtype=np.int64)
    cur_block = 0
    for i in range(1, n_sites):
        total = cis[i - 1] + trans[i - 1]
        if total < min_link:
            cur_block += 1
            block[i] = cur_block
            phase[i] = 0
            continue
        block[i] = cur_block
        if trans[i - 1] > cis[i - 1]:
            phase[i] = 1 - phase[i - 1]
        else:
            phase[i] = phase[i - 1]
    return phase, block


def phase_sites_pairwise(reads_alleles, n_sites, min_link=2,
                         max_pair_span=20):
    """Phase via ALL co-observed site pairs (longphase-style linkage graph,
    run_clair3_rna:729-767 is the stage being replaced), not just consecutive
    sites: every read contributes a cis/trans observation for each pair of
    informative sites it covers (up to max_pair_span index distance), and a
    maximum-spanning-forest over |cis - trans| edge weights orients the
    haplotypes -- strongest evidence first, weighted union-find with parity.

    Returns (phase[n_sites], block[n_sites]) in the same convention as
    phase_sites: phase is relative within a block, the first site of each
    block has phase 0, and blocks are numbered in position order.
    """
    pair_counts: dict = {}
    for alleles in reads_alleles:
        m = len(alleles)
        for a in range(m):
            i, ai = alleles[a]
            for b in range(a + 1, m):
                j, aj = alleles[b]
                if j - i > max_pair_span:
                    break
                key = (i, j)
                counts = pair_counts.get(key)
                if counts is None:
                    counts = pair_counts[key] = [0, 0]
                counts[ai ^ aj] += 1  # [cis, trans]

    edges = []
    for (i, j), (cis, trans) in pair_counts.items():
        if cis + trans < min_link or cis == trans:
            continue
        edges.append((abs(cis - trans), i, j, 1 if trans > cis else 0))
    # strongest linkage first; (i, j) tie-break keeps the result deterministic
    edges.sort(key=lambda e: (-e[0], e[1], e[2]))

    parent = np.arange(n_sites, dtype=np.int64)
    parity = np.zeros(n_sites, dtype=np.int8)  # phase relative to parent

    def find(x):
        path = []
        while parent[x] != x:
            path.append(x)
            x = parent[x]
        root = x
        # path compression: walking root-ward nodes first keeps each node's
        # stored parity (relative to its old parent) valid when read
        p = 0
        for node in reversed(path):
            p ^= parity[node]
            parent[node] = root
            parity[node] = p
        return root, p

    for _, i, j, orient in edges:
        ri, pi = find(i)
        rj, pj = find(j)
        if ri == rj:
            continue  # cycle: earlier (stronger) evidence wins
        # want parity(i) ^ parity(j) == orient after union
        parent[rj] = ri
        parity[rj] = pi ^ pj ^ orient

    phase = np.zeros(n_sites, dtype=np.int8)
    block = np.zeros(n_sites, dtype=np.int64)
    root_block: dict = {}
    root_first_parity: dict = {}
    next_block = 0
    for i in range(n_sites):
        r, p = find(i)
        if r not in root_block:
            root_block[r] = next_block
            root_first_parity[r] = p
            next_block += 1
        block[i] = root_block[r]
        phase[i] = p ^ root_first_parity[r]
    return phase, block


def switch_error_rate(phase, block, truth_phase):
    """Fraction of consecutive same-block site pairs whose predicted relative
    orientation disagrees with the truth (the standard switch-error metric
    whatshap compare reports)."""
    phase = np.asarray(phase)
    block = np.asarray(block)
    truth_phase = np.asarray(truth_phase)
    same_block = block[1:] == block[:-1]
    if not same_block.any():
        return 0.0, 0
    pred_flip = (phase[1:] ^ phase[:-1])[same_block]
    true_flip = (truth_phase[1:] ^ truth_phase[:-1])[same_block]
    n_pairs = int(same_block.sum())
    return float((pred_flip != true_flip).sum()) / n_pairs, n_pairs


def assign_read_haplotypes(reads_alleles, phase, block, min_votes=1):
    """Majority vote -> HP 1/2 per read (0 = untagged). Votes only count
    within the read's dominant phase block."""
    hp = []
    for alleles in reads_alleles:
        if not alleles:
            hp.append(0)
            continue
        blocks = {}
        for si, allele in alleles:
            b = block[si]
            # allele XOR phase: 0 -> haplotype A, 1 -> haplotype B
            side = allele ^ phase[si]
            votes = blocks.setdefault(b, [0, 0])
            votes[side] += 1
        b_best = max(blocks, key=lambda b: sum(blocks[b]))
        a_votes, b_votes = blocks[b_best]
        if a_votes == b_votes or a_votes + b_votes < min_votes:
            hp.append(0)
        elif a_votes > b_votes:
            hp.append(1)
        else:
            hp.append(2)
    return hp
