"""The plain reference of the two-pass job (`call --enable_phasing_model`),
computed from the seed: the first pass's candidates, probabilities and VCF
rows (reference/pileup.py, network.py on the first pass's weights,
judge.expected_rows), each read's HP phased from those rows
(reference/phase.py), and the 30-channel candidates of the re-call
(reference/pileup_phased.py). The pileups and the phasing run in spawned
children, a contig each; the networks on `device`, in float32 with TF32
off. Nothing of the program is imported."""

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass

from callbench.reference.judge import all_candidates, expected_rows
from callbench.reference.network import load_weights, probabilities


@dataclass
class TwoPass:
    first: dict          # contig name -> 18-channel Candidates
    first_probs: dict    # contig name -> [n, 24] float32
    first_rows: dict     # contig name -> the first pass's VCF body rows
    hp: dict             # contig name -> int8 [reads]: each read's HP
    phased: dict         # contig name -> 30-channel Candidates


def contig_haplotypes(traffic, seed, index, params, rows, pos, depth):
    """(HP of each read, the per-haplotype windows [n, 33, 12]) of one
    contig (run in a child)."""
    from callbench.gen.simulate import make_contig
    from callbench.reference.phase import read_haplotypes
    from callbench.reference.pileup import Candidates
    from callbench.reference.pileup_phased import phased_windows

    ctg = make_contig(traffic, seed, index)
    hp = read_haplotypes(ctg, rows)
    cands = Candidates(ctg.name, pos, None, depth, None, None)
    return hp, phased_windows(ctg, hp, params, cands)


def two_pass(traffic, seed, cfg, indices, device, root, first_weights=None):
    """The reference's two passes over the contigs `indices` of the traffic
    mix, under configuration `cfg` (its first_pass_weights, or
    `first_weights`: a loaded weight dict) -> TwoPass."""
    from callbench.reference.pileup_phased import with_haplotypes

    indices = list(indices)
    cands = all_candidates(traffic, seed, cfg, indices)
    w = first_weights or load_weights(os.path.join(root,
                                                   cfg["first_pass_weights"]))
    first, probs, rows = {}, {}, {}
    for i in indices:
        c = cands[i]
        first[c.contig] = c
        probs[c.contig] = probabilities(w, c.tensors, device)
        rows[c.contig] = expected_rows(c, probs[c.contig], cfg["qual_cutoff"])
    with ProcessPoolExecutor(
            max_workers=max(1, min(len(indices), os.cpu_count() or 1)),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        futs = {cands[i].contig: pool.submit(
            contig_haplotypes, traffic, seed, i, cfg,
            rows[cands[i].contig], cands[i].pos, cands[i].depth)
            for i in indices}
        done = {name: f.result() for name, f in futs.items()}
    return TwoPass(first, probs, rows,
                   {n: hp for n, (hp, _) in done.items()},
                   {n: with_haplotypes(first[n], win)
                    for n, (_, win) in done.items()})
