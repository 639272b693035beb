"""A small traffic mix for the CPU tests (the cells' shape on short
contigs), and a copy of the benchmark with one more cell, or one more
configuration, in it."""

import json
import os
import shutil

with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "traffic", "expr_skew.json")) as _f:
    _TRAFFIC = json.load(_f)
# 12 genes of 5 kb: Zipf depths 240 / rank (20x to 240x; rank 1 over 1.5 x
# max_depth), the cells' reads and errors
SKEW = dict(_TRAFFIC, contig_len=60000, genes=12, intron_len=1000,
            zipf_top_depth=240, variants_per_contig=87)
# 6 genes of 10 kb (53x to 320x), exons long enough to read a gene's depth
GENES = dict(SKEW, genes=6, intron_len=2000, zipf_top_depth=320)
CALL = {"pileup_backend": "host", "chunk_size": 20000}
PARAMS = {"min_mq": 5, "snp_min_af": 0.08, "indel_min_af": 0.15,
          "min_coverage": 4, "max_depth": 144, "qual_cutoff": 8}
LIMITS = {"missing_candidates": 0, "prob_gap": 1e-5, "row_mismatch": 0,
          "ref_row_mismatch": 0}


def copy_with_cell(tmp, root, workload, config, traffic, call, limits):
    """The benchmark's files in tmp, plus one traffic file, one cell file
    and one workload entry (named config.traffic): nothing existing is
    edited."""
    shutil.copy(os.path.join(root, "BENCHMARK.json"), tmp)
    shutil.copytree(os.path.join(root, "callbench"), os.path.join(tmp, "callbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    traffic_name = workload[len(config) + 1:]
    with open(os.path.join(tmp, "callbench", "traffic", traffic_name + ".json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(tmp, "callbench", "cells", workload + ".json"), "w") as f:
        json.dump({"call": call, "limits": limits}, f)
    path = os.path.join(tmp, "BENCHMARK.json")
    with open(path) as f:
        b = json.load(f)
    b["workloads"].append({"name": workload, "config": config,
                           "traffic": traffic_name, "chips": 1, "why": "small"})
    with open(path, "w") as f:
        json.dump(b, f)


def add_config(tmp, name, cfg, module):
    """callbench/configs/<name>.json (cfg), its configs entry and, where
    `module` is a path, callbench/configs/<name>.py (a copy of it) in the
    copy at tmp."""
    d = os.path.join(tmp, "callbench", "configs")
    with open(os.path.join(d, name + ".json"), "w") as f:
        json.dump(dict(cfg, name=name), f)
    if module is not None:
        shutil.copy(module, os.path.join(d, name + ".py"))
    path = os.path.join(tmp, "BENCHMARK.json")
    with open(path) as f:
        b = json.load(f)
    b["configs"].append({"name": name, "source": cfg["source"],
                         "file": f"callbench/configs/{name}.json",
                         "reduced": [], "why": "small"})
    with open(path, "w") as f:
        json.dump(b, f)
