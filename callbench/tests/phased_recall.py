"""A configuration module for the tests: the port's phased re-call alone
(30 channels: the 18 first-pass ones and 12 per-haplotype ones) on a BAM
whose reads carry HP tags, with random weights. Copied into a copy of the
benchmark as callbench/configs/<config>.py beside a JSON of its own, it
shows that a configuration with another job and another check is new files
alone. Its check reads only what it was handed: the network rows the
window's jobs captured."""

import os

import numpy as np

from callbench.harness import stats_dict

CHANNELS = 30
FIRST_PASS_CHANNELS = 18


def load(cell):
    from clair3_rna_torch.caller.decode import CallConfig
    from clair3_rna_torch.config import PileupConfig
    from clair3_rna_torch.models.network import (init_params,
                                                 make_wire_forward_fn)
    c = cell.cfg
    pileup_cfg = PileupConfig.for_platform(
        c["preset"], min_mq=c["min_mq"], min_bq=c["min_bq"],
        min_coverage=c["min_coverage"], snp_min_af=c["snp_min_af"],
        indel_min_af=c["indel_min_af"], batch_size=c["batch_size"],
        phased=True)
    _, forward = make_wire_forward_fn()
    return {"pileup_cfg": pileup_cfg, "call_cfg": CallConfig(),
            "params": init_params(0, phased=True, device=cell.device),
            "forward": forward}


def job(cell, contig, out_dir, joblog):
    """The phased re-call of one contig on its HP-tagged BAM."""
    from clair3_rna_torch.caller.pipeline import run_calling
    s = cell.state
    log = os.path.join(out_dir, "joblog.phased.tsv") if joblog else None
    outputs, stats = run_calling(
        contig["bam"], contig["fasta"],
        os.path.join(out_dir, "output_enable_phasing.vcf"),
        cfg=s["pileup_cfg"], call_cfg=s["call_cfg"], params=s["params"],
        forward=s["forward"], contigs=[contig["name"]],
        cmd_line="callbench", compress=True, progress=False,
        manifest_dir=os.path.join(out_dir, "tmp_phased"), resume=False,
        joblog=log, device=cell.device, **cell.call)
    return {"contig": contig["name"], "read_bases": contig["read_bases"],
            "vcf": outputs[0], "joblog": [log] if log else [],
            "stats": [stats_dict(stats)],
            "network_rows": {CHANNELS: stats.candidates}}


def check(cell, device):
    """Captured rows that are not 30-channel, jobs that captured none, and
    whether the haplotype channels of the captured rows read zero
    throughout (or there were none)."""
    caps = [j["captured"] for j in cell.jobs if "captured" in j]
    rows = [c[CHANNELS][0] for c in caps if CHANNELS in c]
    other = sum(len(x) for c in caps for ch, (x, _) in c.items()
                if ch != CHANNELS)
    hp = sum(int(np.abs(x[..., FIRST_PASS_CHANNELS:]).sum()) for x in rows)
    return {"other_channel_rows": other,
            "jobs_without_phased_rows": len(caps) - len(rows),
            "haplotype_channels_empty": int(hp == 0)}, {}
