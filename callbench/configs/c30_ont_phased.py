"""What one job of configuration c30_ont_phased runs, and how its output is
checked: Clair3-RNA's two-pass `call --enable_phasing_model`
(run_clair3_rna:729-852) on one contig.

The harness (callbench/harness.py) finds this file by the configuration's
name and calls its three functions:

- load(cell) -> state: c18_ont's load (the first pass's network at 18
  channels, the pileup and call settings, the forward function), and the
  phasing model's weights at 30 channels onto the card. Timed as weights_s
  inside setup_s.
- job(cell, contig, out_dir, joblog) -> record: the first pass (c18_ont's
  job, from that configuration's own file), then the program's second
  pass (caller/driver.run_second_pass, the function `call
  --enable_phasing_model` runs): phase + haplotag into out_dir's tagged
  BAM, and the 30-channel re-call on it.
- check(cell, device) -> (numbers, seconds): the plain reference's numbers
  (reference/twopass.py) for what the window's jobs produced. It imports
  only callbench.reference, never the program.
"""

import os
import time
from types import SimpleNamespace

from callbench.harness import config_module, stats_dict


def _first_pass(cell, state=None):
    """c18_ont's module, and `cell` as its load and job see it: the first
    pass's width and weights."""
    c = cell.cfg
    view = SimpleNamespace(
        cfg=dict(c, channels=c["first_pass_channels"],
                 weights=c["first_pass_weights"]),
        root=cell.root, device=cell.device, call=cell.call, state=state)
    return config_module("c18_ont", cell.root), view


def load(cell):
    from clair3_rna_torch.models.params_io import (load_params,
                                                   params_from_numpy)
    c18, view = _first_pass(cell)
    state = c18.load(view)
    state["phased_params"] = params_from_numpy(
        load_params(os.path.join(cell.root, cell.cfg["weights"])),
        device=cell.device)
    return state


def job(cell, contig, out_dir, joblog):
    """c18_ont's job, then the second pass on its VCF; both joblogs in
    out_dir when `joblog`."""
    from clair3_rna_torch.caller.driver import run_second_pass
    s = cell.state
    t0 = time.perf_counter()
    c18, view = _first_pass(cell, s)
    rec = c18.job(view, contig, out_dir, joblog)
    log = os.path.join(out_dir, "joblog.phased.tsv") if joblog else None
    second, st2 = run_second_pass(
        contig["bam"], contig["fasta"], rec["vcf"], out_dir,
        cfg=s["pileup_cfg"], call_cfg=s["call_cfg"], params=s["phased_params"],
        forward=s["forward"], contigs=[contig["name"]],
        phaser=cell.cfg["phaser"], cmd_line="callbench", compress=True,
        progress=False, joblog=log, device=cell.device, **cell.call)
    rec["network_rows"][cell.cfg["channels"]] = st2.candidates
    rec.update(vcf=second[0], first_vcf=rec["vcf"],
               tagged_bam=os.path.join(out_dir, "phased_tagged.bam"),
               joblog=rec["joblog"] + ([log] if log else []),
               stats=rec["stats"] + [stats_dict(st2)], phase=st2.phase,
               wall_s=time.perf_counter() - t0)
    return rec


def check(cell, device):
    """The reference's numbers for what the window's jobs produced: c18_ont's
    four on the first pass, the same four on the re-call (prefixed
    phased_), and hp_mismatch; and the seconds the reference took."""
    from callbench.reference.bam import read_hp
    from callbench.reference.judge import judge, vcf_body
    from callbench.reference.network import load_weights, probabilities
    from callbench.reference.twopass import two_pass

    cfg, jobs = cell.cfg, cell.jobs
    t = time.perf_counter()
    ref = two_pass(cell.traffic, cell.seed, cfg, range(len(cell.contigs)),
                   device, cell.root)
    secs = {"reference_s": time.perf_counter() - t}
    w = load_weights(os.path.join(cell.root, cfg["weights"]))
    phased_probs = {n: probabilities(w, c.tensors, device)
                    for n, c in ref.phased.items()}
    numbers = {}
    first = cfg["first_pass_channels"]
    for prefix, ch, cands, probs, vcf in (
            ("", first, ref.first, ref.first_probs, "first_vcf"),
            ("phased_", cfg["channels"], ref.phased, phased_probs, "vcf")):
        caps = [(j["contig"],) + j["captured"][ch] for j in jobs
                if ch in j.get("captured", {})]
        bodies = [(j["contig"], vcf_body(j[vcf])) for j in jobs]
        for k, v in judge(cands, probs, caps, bodies,
                          cfg["qual_cutoff"]).items():
            numbers[prefix + k] = v
    firsts = {}
    for j in jobs:
        firsts.setdefault(j["contig"], j["tagged_bam"])
    numbers["hp_mismatch"] = sum(hp_mismatch(ref.hp[c], read_hp(path))
                                 for c, path in firsts.items())
    return numbers, secs


def hp_mismatch(hp, records):
    """Records whose HP differs from the reference's HP of read r<i> (0:
    untagged), plus the reference's reads missing from the records and
    records added to them (a name seen twice counts once more)."""
    want = {f"r{i}": int(h) for i, h in enumerate(hp)}
    bad, seen = 0, set()
    for name, h in records:
        if name in seen or name not in want:
            bad += 1
            continue
        seen.add(name)
        bad += int(h) != want[name]
    return bad + len(want) - len(seen)
