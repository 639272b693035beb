"""--pileup_backend hybrid on the port: backend resolution (as
tests/test_backend.py), the per-chunk router held to the JAX package's
ChunkRoutePolicy on the same call sequence, one test per repair the port
makes to that router, and hybrid `call` runs whose VCF bodies equal the
JAX host route's with both routes used (as tests/test_hybrid_backend.py).

The repairs change which route a chunk takes, never its rows:
- one route measured: its wall is compared with the cost model's prior for
  the other route (the JAX policy pins the measured route);
- observe_wall files a wall under the bucket route() chose (the JAX policy
  re-estimates it from a ratio that may have moved);
- cold start: at most one chunk routed fused until a fused chunk finishes;
- fused failures back off fused routing in their bucket.
"""

import random

import pytest
import torch

# one intra-op thread: the suite runs six worker processes on a
# shared host, where PyTorch's spinning thread pools oversubscribe it
torch.set_num_threads(1)

LINK = 130e6


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """chr1 30 kb at depth 14 with a ~200x island over 15-30 kb, indexed:
    shallow and deep chunks in one BAM. Weights: the port's init_params(0)
    as npz for both packages."""
    from clair3_rna_torch import simdata
    from clair3_rna_torch.io.bai import build_index
    from clair3_rna_torch.io.fasta import write_fasta
    from clair3_rna_torch.models.network import init_params
    from clair3_rna_torch.models.params_io import save_params

    d = tmp_path_factory.mktemp("hybrid")
    rng = random.Random(53)
    genome = simdata.random_genome(rng, [("chr1", 30_000)])
    variants = simdata.plant_variants(rng, genome, n_per_contig=60)
    fasta, bam = str(d / "ref.fa"), str(d / "reads.bam")
    write_fasta(fasta, genome)
    simdata.simulate_bam(bam, genome, variants, rng, depth=14,
                         extra_regions={"chr1": [(15_000, 30_000, 190)]})
    build_index(bam)
    weights = save_params(str(d / "w.npz"), init_params(0, device="cpu"))
    return {"dir": d, "fasta": fasta, "bam": bam, "weights": weights}


# --- backend resolution (tests/test_backend.py:11-48) -----------------------

def test_explicit_choice_passthrough(monkeypatch):
    from clair3_rna_torch.caller import backend as be

    monkeypatch.delenv("CLAIR3_RNA_TORCH_PILEUP_BACKEND", raising=False)
    assert be.resolve_backend("host") == "host"
    assert be.resolve_backend("fused") == "fused"
    assert be.resolve_backend("hybrid") == "hybrid"
    assert be.resolve_backend(None) == "host"


def test_env_var_is_the_operator_override(monkeypatch):
    from clair3_rna_torch.caller import backend as be

    monkeypatch.setenv("CLAIR3_RNA_TORCH_PILEUP_BACKEND", "hybrid")
    assert be.resolve_backend(None) == "hybrid"
    assert be.resolve_backend("host") == "host"


def test_bad_value_rejected(monkeypatch):
    from clair3_rna_torch.caller import backend as be

    monkeypatch.delenv("CLAIR3_RNA_TORCH_PILEUP_BACKEND", raising=False)
    with pytest.raises(ValueError):
        be.resolve_backend("gpu")


def test_auto_picks_host(monkeypatch):
    """auto stays host on the port (no measured rule for the card yet)."""
    from clair3_rna_torch.caller import backend as be

    monkeypatch.delenv("CLAIR3_RNA_TORCH_PILEUP_BACKEND", raising=False)
    assert be.resolve_backend("auto") == "host"
    backend, reason = be.choose_backend()
    assert backend == "host" and reason


def test_builder_count_env_values_mean_host_pipeline(monkeypatch):
    from clair3_rna_torch.caller import backend as be

    for v in ("device", "kernel"):
        monkeypatch.setenv("CLAIR3_RNA_TORCH_PILEUP_BACKEND", v)
        assert be.resolve_backend(None) == "host"


# --- the router against the JAX package's --------------------------------

def _policies(bam, link=LINK):
    from clair3_rna_torch.caller import backend as tbe
    from clair3_rna_tpu.caller import backend as jbe

    return (tbe.ChunkRoutePolicy(bam, link, {"chr1": 0}),
            jbe.ChunkRoutePolicy(bam, link, {"chr1": 0}))


def _set_cadence(monkeypatch, explore=25, probe=4, preference=1.25):
    """The router's knobs, on both packages' modules."""
    from clair3_rna_torch.caller import backend as tbe
    from clair3_rna_tpu.caller import backend as jbe

    for mod in (tbe, jbe):
        monkeypatch.setattr(mod, "ROUTE_EXPLORE_EVERY", explore)
        monkeypatch.setattr(mod, "ROUTE_PROBE_AFTER", probe)
        monkeypatch.setattr(mod, "FUSED_PREFERENCE", preference)


SHALLOW = [("chr1", lo, lo + 10_000) for lo in (0, 2_500, 5_000)]
DEEP = [("chr1", lo, lo + 10_000) for lo in (15_000, 17_500, 20_000)]


def test_policy_decisions_match_jax(mixed, monkeypatch):
    """The same sequence of route/observe/observe_wall calls, in states no
    repair touches (every fused chunk finishes before the next is routed,
    no failure, no ratio change between a route and its wall, a lone
    measured route no dearer than the prior's other route), gives the same
    decisions, estimates and wall EWMAs on both policies."""
    _set_cadence(monkeypatch, explore=5, probe=3)
    port, ref = _policies(mixed["bam"])
    rng = random.Random(7)
    walls = {("shallow", "fused"): 0.002, ("shallow", "host"): 0.004,
             ("deep", "fused"): 0.08, ("deep", "host"): 0.02}
    decisions = {"port": [], "jax": []}
    for i in range(60):
        region = rng.choice(SHALLOW + DEEP)
        kind = "shallow" if region in SHALLOW else "deep"
        bases = (14 if kind == "shallow" else 200) * 10_000 \
            * rng.uniform(0.8, 1.2)
        for name, pol in (("port", port), ("jax", ref)):
            if i % 7 == 3:
                pol.observe(*region, bases)
            est = pol.estimate_bases(*region)
            route = pol.route(*region)
            wall = walls[(kind, route)] * (1 + 0.1 * (i % 3))
            pol.observe_wall(route, *region, wall, compiled=(i == 0))
            decisions[name].append((route, round(est, 6)))
    assert decisions["port"] == decisions["jax"]
    routes = [r for r, _ in decisions["port"]]
    assert "fused" in routes and "host" in routes
    pc, jc = port.counters(), ref.counters()
    for key in ("fused_chunks", "host_chunks", "explore_chunks",
                "bases_per_cbyte", "bucket_walls"):
        assert pc[key] == jc[key], key
    assert len(pc["bucket_walls"]) >= 2


def test_lone_measured_route_meets_the_prior(mixed, monkeypatch):
    """One route measured: a measured host wall far above the prior's fused
    estimate routes the next chunk fused at once (the JAX policy pins host
    until its probe cadence)."""
    _set_cadence(monkeypatch, explore=25, probe=4)
    port, ref = _policies(mixed["bam"])
    region = SHALLOW[0]
    for pol in (port, ref):
        pol.observe_wall("host", *region, 5.0)
    assert port.route(*region) == "fused"
    assert ref.route(*region) == "host"
    # ... and a measured route that is the cheaper stays
    port2, _ = _policies(mixed["bam"])
    port2.observe_wall("host", *region, 1e-4)
    assert [port2.route(*region) for _ in range(3)] == ["host"] * 3


def test_wall_lands_in_the_routed_bucket(mixed):
    """observe_wall files the wall under the bucket route() chose, even
    when the bases-per-byte ratio moved in between (the JAX policy
    re-estimates and files it elsewhere)."""
    port, ref = _policies(mixed["bam"])
    region = DEEP[0]
    buckets = []
    for pol in (port, ref):
        pol.route(*region)
        buckets.append(pol._bucket(pol.estimate_bases(*region)))
        for _ in range(12):   # a chunk reports 64x fewer bases
            pol.observe(*region, pol.estimate_bases(*region) / 64)
        pol.observe_wall("host", *region, 0.05)
    assert buckets[0] == buckets[1]
    assert list(port.counters()["bucket_walls"]) == [buckets[0]]
    assert list(ref.counters()["bucket_walls"]) != [buckets[1]]


def test_cold_start_routes_one_fused_chunk(mixed, monkeypatch):
    """Until a fused chunk finishes, at most one chunk is routed fused;
    a finished one-off pass (its wall discarded) lifts the gate."""
    _set_cadence(monkeypatch, preference=4.0)
    port, ref = _policies(mixed["bam"], link=8e9)
    assert [ref.route(*r) for r in SHALLOW[:2]] == ["fused", "fused"]
    assert [port.route(*r) for r in SHALLOW[:2]] == ["fused", "host"]
    port.observe_wall("fused", *SHALLOW[0], 30.0, compiled=True)
    assert port.counters()["bucket_walls"] == {}
    assert port.route(*SHALLOW[2]) == "fused"
    assert port.route(*SHALLOW[1]) == "fused"


def test_fused_failures_back_off(mixed, monkeypatch):
    """A chunk the fused pass hands back to the host counts against its
    bucket: fused is retried after ROUTE_PROBE_AFTER chunks, then twice
    that after a second failure; a fused wall clears the count."""
    _set_cadence(monkeypatch, probe=2, preference=4.0)
    port, ref = _policies(mixed["bam"], link=8e9)
    region = SHALLOW[0]
    assert port.route(*region) == "fused"
    port.observe_failure(*region)
    got = [port.route(*region) for _ in range(2)]
    assert got == ["host", "fused"]
    port.observe_failure(*region)
    got = [port.route(*region) for _ in range(4)]
    assert got == ["host", "host", "host", "fused"]
    port.observe_wall("fused", *region, 0.001)
    port.observe_wall("host", *region, 1.0)
    assert [port.route(*region) for _ in range(3)] == ["fused"] * 3
    c = port.counters()
    assert c["fused_failures"] == 2
    # the JAX policy keeps routing the failing chunk class fused
    assert [ref.route(*region) for _ in range(4)] == ["fused"] * 4


def test_link_probe_is_cached(monkeypatch):
    """The link probe runs once per process and device type (a plain
    tensor copy on the CPU)."""
    from clair3_rna_torch.caller import backend as tbe

    calls = []

    def probe(device, nbytes=1 << 20):
        calls.append(device)
        return 1e9

    monkeypatch.setattr(tbe, "_LINK_BPS_CACHE", {})
    monkeypatch.setattr(tbe, "probe_link_bandwidth", probe)
    assert tbe.cached_link_bandwidth("cpu") == 1e9
    assert tbe.cached_link_bandwidth(torch.device("cpu")) == 1e9
    assert len(calls) == 1
    monkeypatch.undo()
    assert tbe.probe_link_bandwidth("cpu", nbytes=1 << 20) > 0


# --- hybrid `call` end to end (tests/test_hybrid_backend.py:53,80) ----------

@pytest.fixture(scope="module")
def jax_host_body(mixed):
    from clair3_rna_tpu.caller.decode import CallConfig
    from clair3_rna_tpu.caller.pipeline import run_calling
    from clair3_rna_tpu.config import PileupConfig
    from clair3_rna_tpu.models.params_io import load_params

    out = str(mixed["dir"] / "jax_host.vcf")
    run_calling(mixed["bam"], mixed["fasta"], out,
                cfg=PileupConfig(batch_size=256),
                call_cfg=CallConfig(show_ref=False),
                params=load_params(mixed["weights"]), contigs=["chr1"],
                chunk_size=5_000, compress=False, progress=False,
                pileup_backend="host")
    return [line for line in open(out) if not line.startswith("#")]


@pytest.mark.parametrize("link", [LINK, 8e9])
def test_hybrid_call_matches_jax_host(mixed, jax_host_body, tmp_path,
                                      monkeypatch, link):
    """`call --pileup_backend hybrid --device cpu` (through the CLI, six
    5 kb chunks, two prefetch threads) on a mid-grade and a card-local
    link: the body equals the JAX host route's, and both routes served
    chunks. Routing depends on completion order, so the test asserts rows
    and "both routes used", not per-chunk routes."""
    from clair3_rna_torch.caller import backend as tbe
    from clair3_rna_torch.caller import pipeline as tpl
    from clair3_rna_torch.cli import main

    monkeypatch.setattr(tbe, "cached_link_bandwidth", lambda device: link)
    monkeypatch.setattr(tbe, "ROUTE_PROBE_AFTER", 1)
    # the operator's preference knob, set so that the prior routes the
    # shallow 5 kb chunks fused and the deep ones host at either link
    monkeypatch.setattr(tbe, "FUSED_PREFERENCE", 4.0)
    monkeypatch.setattr(tpl, "_ROUTE_POLICIES", type(tpl._ROUTE_POLICIES)())
    monkeypatch.setenv("CLAIR3_RNA_TORCH_NATIVE_THREADS", "1")
    out = tmp_path / "out"
    outputs, stats = main([
        "call", "-B", mixed["bam"], "-R", mixed["fasta"], "-o", str(out),
        "--model_path", mixed["weights"], "--device", "cpu",
        "--pileup_backend", "hybrid", "--chunk_size", "5000",
        "--no_compress", "--include_all_ctgs"])
    body = [line for line in open(outputs[0]) if not line.startswith("#")]
    assert len(jax_host_body) > 20
    assert body == jax_host_body
    r = stats.routing
    assert r["fused_chunks"] + r["host_chunks"] == 6
    assert r["fused_chunks"] >= 1 and r["host_chunks"] >= 1
    assert r["link_bps"] == link
    assert stats.fused["fallback_chunks"] == r["fused_failures"]
