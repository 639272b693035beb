"""What one job of configuration c18_ont runs, and how its output is checked.

The harness (callbench/harness.py) finds this file by the configuration's
name and calls its three functions:

- load(cell) -> state: the weights onto the card, the pileup and call
  settings and the forward function, from the configuration's JSON. Timed
  as weights_s inside setup_s; the harness keeps the state as cell.state
  and drops it before the check.
- job(cell, contig, out_dir, joblog) -> record: one first-pass `call` of
  one contig (run_calling) into the fresh directory out_dir.
- check(cell, device) -> (numbers, seconds): the plain reference's numbers
  for what the window's jobs produced. It imports only callbench.reference,
  never the program.
"""

import os
import time

from callbench.harness import stats_dict


def load(cell):
    from clair3_rna_torch.caller.decode import CallConfig
    from clair3_rna_torch.config import PileupConfig
    from clair3_rna_torch.models.network import make_wire_forward_fn
    from clair3_rna_torch.models.params_io import (load_params,
                                                   params_from_numpy)
    c = cell.cfg
    pileup_cfg = PileupConfig.for_platform(
        c["preset"], min_mq=c["min_mq"], min_bq=c["min_bq"],
        min_coverage=c["min_coverage"], snp_min_af=c["snp_min_af"],
        indel_min_af=c["indel_min_af"], batch_size=c["batch_size"])
    call_cfg = CallConfig()
    params = params_from_numpy(
        load_params(os.path.join(cell.root, c["weights"])),
        device=cell.device)
    _, forward = make_wire_forward_fn()
    return {"pileup_cfg": pileup_cfg, "call_cfg": call_cfg,
            "params": params, "forward": forward}


def job(cell, contig, out_dir, joblog):
    """One `call` of one contig; its joblog in out_dir when `joblog`."""
    from clair3_rna_torch.caller.pipeline import run_calling
    s = cell.state
    log = os.path.join(out_dir, "joblog.tsv") if joblog else None
    outputs, stats = run_calling(
        contig["bam"], contig["fasta"], os.path.join(out_dir, "output.vcf"),
        cfg=s["pileup_cfg"], call_cfg=s["call_cfg"], params=s["params"],
        forward=s["forward"], contigs=[contig["name"]],
        cmd_line="callbench", compress=True, progress=False,
        manifest_dir=os.path.join(out_dir, "tmp"), resume=False,
        joblog=log, device=cell.device, **cell.call)
    return {"contig": contig["name"], "read_bases": contig["read_bases"],
            "vcf": outputs[0], "joblog": [log] if log else [],
            "stats": [stats_dict(stats)],
            "network_rows": {cell.cfg["channels"]: stats.candidates}}


def check(cell, device):
    """The reference's numbers for what the window's jobs produced, and the
    seconds its pileups took in their children."""
    from callbench.reference.judge import all_candidates, judge, vcf_body
    from callbench.reference.network import load_weights, probabilities

    cfg, jobs = cell.cfg, cell.jobs
    t = time.perf_counter()
    cands = all_candidates(cell.traffic, cell.seed, cfg, range(len(cell.contigs)))
    secs = {"pileup_s": time.perf_counter() - t}
    by_name = {c.contig: c for c in cands.values()}
    w = load_weights(os.path.join(cell.root, cfg["weights"]))
    ref = {n: probabilities(w, c.tensors, device) for n, c in by_name.items()}
    caps = [(j["contig"],) + j["captured"][cfg["channels"]] for j in jobs
            if cfg["channels"] in j.get("captured", {})]
    bodies = [(j["contig"], vcf_body(j["vcf"])) for j in jobs]
    return judge(by_name, ref, caps, bodies, cfg["qual_cutoff"]), secs
