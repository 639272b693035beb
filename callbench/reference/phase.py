"""Plain read-backed phasing of a simulated contig: each read's haplotag
(HP 1, 2, or 0 for untagged), straight from the generator's reads.

A frozen copy of the program's builtin phaser (clair3_rna_torch/phasing:
phase.py's site selection, allele, linkage and vote rules, and the read
filter of pipeline.py), taken when the phasing model's configuration was
defined, with the BAM walk replaced by the generator's aligned bases:

- sites: the heterozygous SNVs of a first-pass VCF body (0/1 in either
  order, one base REF and ALT; reference calls dropped);
- a read's alleles: at each site its aligned base (the generator's
  al_pos/al_code: M positions only, none inside a deletion or an intron)
  is 1 for ALT, 0 for REF, nothing for another base; reads with a flag of
  2316 or MAPQ under 5 take no part and stay untagged;
- linkage: a cis/trans count for every pair of a read's sites at most 20
  sites apart, edges of at least 2 reads and unequal counts by |cis -
  trans|, strongest first, into a union-find with parity;
- a read's HP: the majority of its votes in its best-supported block, 0 on
  a tie.

Nothing of the program is imported.
"""

import numpy as np

EXCLUDE_FLAGS = 2316
MIN_MQ = 5
_CODE = {b: i for i, b in enumerate("ACGT")}


def het_sites(rows):
    """[(0-based position, REF code, ALT code)] of the phasable
    heterozygous SNVs among VCF body rows, by position."""
    sites = {}
    for row in rows:
        cols = row.split("\t")
        ref, alt = cols[3], cols[4]
        if alt == "." or ref == alt:
            continue
        if len(ref) != 1 or "," in alt or len(alt) != 1:
            continue
        gt = cols[9].split(":")[0].replace("|", "/").split("/") \
            if len(cols) > 9 else ["0", "0"]
        try:
            gt = sorted(int(g) if g != "." else -1 for g in gt)
        except ValueError:
            continue
        if gt != [0, 1]:
            continue
        sites[int(cols[1]) - 1] = (_CODE.get(ref, -1), _CODE.get(alt, -1))
    return [(p,) + sites[p] for p in sorted(sites)]


def read_alleles(ctg, sites):
    """Each read's [(site index, allele)] in position order, for every read
    of the contig (empty where it takes no part)."""
    plan = ctg.plan
    n = len(plan.start)
    flag = plan.strand.astype(np.int64) * 16
    use = ((flag & EXCLUDE_FLAGS) == 0) & (plan.mapq >= MIN_MQ)
    out = [[] for _ in range(n)]
    if not sites:
        return out
    pos = np.array([s[0] for s in sites], np.int64)
    ref = np.array([s[1] for s in sites], np.int64)
    alt = np.array([s[2] for s in sites], np.int64)
    for blk in ctg.blocks(with_query=False):
        at = np.searchsorted(pos, blk.al_pos)
        hit = at < len(pos)
        hit[hit] = pos[at[hit]] == blk.al_pos[hit]
        hit &= use[blk.al_read]
        si, code, read = at[hit], blk.al_code[hit].astype(np.int64), \
            blk.al_read[hit]
        allele = np.where(code == alt[si], 1, np.where(code == ref[si], 0, -1))
        keep = allele >= 0
        si, allele, read = si[keep], allele[keep], read[keep]
        order = np.lexsort((si, read))
        for r, i, a in zip(read[order].tolist(), si[order].tolist(),
                           allele[order].tolist()):
            out[r].append((i, a))
    return out


def phase_sites_pairwise(reads_alleles, n_sites, min_link=2,
                         max_pair_span=20):
    """(phase[n_sites], block[n_sites]): phase relative within a block, the
    first site of each block 0, blocks numbered in position order."""
    pair_counts = {}
    for alleles in reads_alleles:
        m = len(alleles)
        for a in range(m):
            i, ai = alleles[a]
            for b in range(a + 1, m):
                j, aj = alleles[b]
                if j - i > max_pair_span:
                    break
                counts = pair_counts.get((i, j))
                if counts is None:
                    counts = pair_counts[(i, j)] = [0, 0]
                counts[ai ^ aj] += 1  # [cis, trans]

    edges = []
    for (i, j), (cis, trans) in pair_counts.items():
        if cis + trans < min_link or cis == trans:
            continue
        edges.append((abs(cis - trans), i, j, 1 if trans > cis else 0))
    edges.sort(key=lambda e: (-e[0], e[1], e[2]))

    parent = list(range(n_sites))
    parity = [0] * n_sites  # phase relative to parent

    def find(x):
        path = []
        while parent[x] != x:
            path.append(x)
            x = parent[x]
        p = 0
        for node in reversed(path):
            p ^= parity[node]
            parent[node] = x
            parity[node] = p
        return x, p

    for _, i, j, orient in edges:
        ri, pi = find(i)
        rj, pj = find(j)
        if ri == rj:
            continue  # a cycle: the stronger evidence came first
        parent[rj] = ri
        parity[rj] = pi ^ pj ^ orient

    phase = np.zeros(n_sites, np.int8)
    block = np.zeros(n_sites, np.int64)
    first = {}
    for i in range(n_sites):
        r, p = find(i)
        if r not in first:
            first[r] = (len(first), p)
        block[i] = first[r][0]
        phase[i] = p ^ first[r][1]
    return phase, block


def assign_read_haplotypes(reads_alleles, phase, block):
    """HP 1/2 a read (0 untagged): the majority of its votes within its
    best-supported block (the first such block on a tie of support)."""
    hp = np.zeros(len(reads_alleles), np.int8)
    for r, alleles in enumerate(reads_alleles):
        if not alleles:
            continue
        votes = {}
        for si, allele in alleles:
            v = votes.setdefault(int(block[si]), [0, 0])
            v[allele ^ int(phase[si])] += 1
        a, b = votes[max(votes, key=lambda k: sum(votes[k]))]
        if a != b:
            hp[r] = 1 if a > b else 2
    return hp


def read_haplotypes(ctg, rows):
    """int8 [reads]: the HP of each read of the contig (in the generator's
    coordinate order, read i named r<i>), phased on the het SNVs of the
    first-pass VCF body `rows`."""
    sites = het_sites(rows)
    alleles = read_alleles(ctg, sites)
    phase, block = phase_sites_pairwise(alleles, len(sites))
    return assign_read_haplotypes(alleles, phase, block)
