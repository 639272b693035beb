"""The plain reference against the program on the CPU: on a small generated
contig, the reference's candidates, tensors, probabilities and VCF rows
equal what the program's --device cpu run fed its network and wrote; and a
mutation planted in the reference breaks the agreement."""

import os

import numpy as np
import pytest
import torch

from callbench.gen.bam import write_sample
from callbench.reference import decode, network, pileup
from callbench.reference.judge import (contig_candidates, expected_rows,
                                       judge, match, vcf_body)
from callbench.tests.small import CALL, LIMITS, PARAMS, SKEW

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
C18 = os.path.join(ROOT, "callbench", "weights", "c18_ont.npz")
SEED = 2**31 + 99


def program_call(tmp, backend):
    """The program's call of contig 0 on the CPU -> (network rows, VCF body)."""
    from clair3_rna_torch.caller.decode import CallConfig
    from clair3_rna_torch.caller.pipeline import run_calling
    from clair3_rna_torch.config import PileupConfig
    from clair3_rna_torch.models.network import make_wire_forward_fn
    from clair3_rna_torch.models.params_io import load_params, params_from_numpy

    info = write_sample(SKEW, SEED, 0, str(tmp))
    net = params_from_numpy(load_params(C18), device="cpu")
    _, fwd = make_wire_forward_fn()
    rows = []
    hook = torch.nn.modules.module.register_module_forward_hook(
        lambda m, i, o: rows.append((i[0].clone(), o.clone()))
        if type(m).__name__ == "PileupNet" else None)
    try:
        cfg = PileupConfig.for_platform(
            "ont_dorado_drna004", min_mq=5, min_bq=0, min_coverage=4,
            snp_min_af=0.08, indel_min_af=0.15, batch_size=2048)
        outs, _ = run_calling(
            info["bam"], info["fasta"], str(tmp / "out" / "output.vcf"),
            cfg=cfg, call_cfg=CallConfig(), params=net, forward=fwd,
            contigs=[info["name"]], chunk_size=CALL["chunk_size"],
            progress=False, manifest_dir=str(tmp / "out" / "tmp"),
            pileup_backend=backend, device="cpu")
    finally:
        hook.remove()
    x = torch.cat([a for a, _ in rows]).numpy().astype(np.int32)
    p = torch.cat([b for _, b in rows]).numpy()
    return x, p, vcf_body(outs[0])


@pytest.fixture(scope="module")
def program(tmp_path_factory):
    return {b: program_call(tmp_path_factory.mktemp(b), b)
            for b in ("host", "fused")}


def reference_numbers(x, p, body, params=PARAMS, weights=None):
    cands = contig_candidates(SKEW, SEED, 0, params)
    w = weights or network.load_weights(C18)
    ref = network.probabilities(w, cands.tensors, "cpu")
    return judge({cands.contig: cands}, {cands.contig: ref},
                 [(cands.contig, x, p)], [(cands.contig, body)],
                 PARAMS["qual_cutoff"])


@pytest.mark.parametrize("backend", ["host", "fused"])
def test_reference_equals_program(program, backend):
    x, p, body = program[backend]
    cands = contig_candidates(SKEW, SEED, 0, PARAMS)
    assert len(cands.pos) > 200 and (cands.depth > 216).any()
    kinds = {k[0] for _, d in cands.alt_data for k in d}
    assert {"X", "I", "D", "R"} <= kinds
    probs, missing = match(cands, x, p)
    assert missing == 0
    ref = network.probabilities(network.load_weights(C18), cands.tensors, "cpu")
    assert np.abs(probs - ref).max() < 1e-5
    assert expected_rows(cands, probs, 8) == body
    assert expected_rows(cands, ref, 8) == body
    nums = reference_numbers(x, p, body)
    assert all(nums[k] <= LIMITS[k] for k in LIMITS), nums


def _initial_weights(path):
    from callbench.reference.train import keras_layout, make_net
    torch.manual_seed(0)
    out = str(path / "initial.npz")
    np.savez(out, **keras_layout(make_net(18)))
    return out


@pytest.mark.parametrize("which", ["trained", "initial"])
def test_reference_network_equals_program_network(tmp_path, which):
    from clair3_rna_torch.models.params_io import load_params, params_from_numpy
    weights = C18 if which == "trained" else _initial_weights(tmp_path)
    w = network.load_weights(weights)
    ch = w["lstm1/forward/kernel"].shape[0]
    rng = np.random.default_rng(3)
    x = rng.integers(0, 60, (300, 33, ch)).astype(np.int32)
    x[:, :, 0] = -x[:, :, 1:4].sum(axis=2)  # a negated reference channel
    net = params_from_numpy(load_params(weights), device="cpu")
    with torch.inference_mode():
        prog = net(torch.from_numpy(x.astype(np.float32))).numpy()
    assert np.abs(prog - network.probabilities(w, x, "cpu")).max() < 1e-5


def _bias_flipped():
    w = network.load_weights(C18)
    w["gt21_logits/bias"] = -w["gt21_logits/bias"]
    return {"weights": w}


@pytest.mark.parametrize("mutation", ["af", "channel", "network", "decode"])
def test_planted_reference_mutation_fails(program, monkeypatch, mutation):
    x, p, body = program["host"]
    kwargs = {}
    if mutation == "af":
        kwargs["params"] = dict(PARAMS, snp_min_af=0.05)
    elif mutation == "channel":
        monkeypatch.setattr(pileup, "CH_STAR", pileup.CH_D1)
    elif mutation == "network":
        kwargs.update(_bias_flipped())
    else:
        real = decode.quality_score_from
        monkeypatch.setattr(decode, "quality_score_from",
                            lambda prob: real(prob) + 0.01)
    nums = reference_numbers(x, p, body, **kwargs)
    assert any(nums[k] > LIMITS[k] for k in LIMITS), nums
