"""The pure-array builder's channel counts (K4) in the PyTorch port against
the JAX package.

The port's plain PyTorch version (what `pileup_counts_kernel` runs on CPU
tensors) and its torch.bincount version must equal a numpy oracle and the
JAX package's Pallas kernel run in interpret mode EXACTLY (integer
counts), at 18, 30 and 4 channels, for events in any order. The pure-array
builder with the kernel backend must give the same tensor rows as its host
backend and as the JAX package's device backend. The CUDA kernel against
the plain version runs only on a card (marker `cuda`), on shuffled events.
"""

import numpy as np
import pytest
import torch

from clair3_rna_torch.ops import pileup_kernel as tpk

# one intra-op thread: the suite runs six worker processes on a
# shared host, where PyTorch's spinning thread pools oversubscribe it
torch.set_num_threads(1)


def _oracle(pos, chan, length, n_channels):
    out = np.zeros((length, n_channels), np.int64)
    np.add.at(out, (pos, chan), 1)
    return out


def _random_events(seed, n_events, length, n_channels):
    """Clumped like read pileups (as tests/test_pileup_kernel.py)."""
    rng = np.random.RandomState(seed)
    centers = rng.randint(0, length, size=max(1, n_events // 50))
    pos = np.clip(rng.choice(centers, n_events)
                  + rng.randint(-40, 40, n_events), 0, length - 1)
    chan = rng.randint(0, n_channels, n_events)
    return pos.astype(np.int32), chan.astype(np.int32)


def _uneven(n_channels):
    """Everything piled on one 512-position tile, the others empty."""
    rng = np.random.RandomState(2)
    pos = rng.randint(512, 512 + 30, size=9000).astype(np.int32)
    return pos, rng.randint(0, n_channels, size=9000).astype(np.int32)


CASES = {
    "18ch": (lambda: _random_events(1, 3000, 600, 18), 600, 18),
    "18ch_uneven": (lambda: _uneven(18), 4 * 512, 18),
    "30ch_phased": (lambda: _random_events(3, 40000, 2100, 30), 2100, 30),
    "4ch_groups": (lambda: _random_events(4, 5000, 700, 4), 700, 4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_counts_match_jax(case):
    from clair3_rna_tpu.ops import pileup_kernel as jpk

    make, length, n_ch = CASES[case]
    pos, chan = make()
    want = _oracle(pos, chan, length, n_ch)
    got = {
        "kernel_backend": tpk.pileup_counts(pos, chan, length, n_ch,
                                            "kernel", "cpu"),
        "device_backend": tpk.pileup_counts(pos, chan, length, n_ch,
                                            "device", "cpu"),
        "pallas": jpk.pileup_counts_pallas(pos, chan, length, n_ch,
                                           interpret=True),
        "jax_xla": jpk.pileup_counts_jax(pos, chan, length, n_ch),
    }
    for name, arr in got.items():
        assert arr.shape == (length, n_ch), name
        np.testing.assert_array_equal(arr, want, err_msg=name)
    assert got["kernel_backend"].dtype == np.int32
    assert got["device_backend"].dtype == np.int32


def test_plain_pads_and_empty_input():
    """-1 pads (the JAX staging's), positions at or beyond length_pad and
    channels beyond 31 are inert; `prepare` keeps the events' order and
    only converts dtypes and pads the length; zero events return zeros
    with no launch."""
    pos = np.array([-1, -1, 3, 3, 255, 256, 511, 512, 600], np.int64)
    chan = np.array([0, 5, 17, 17, 31, 40, 29, 1, 0], np.int64)
    ev_pos, ev_chan, length_pad = tpk.prepare(pos, chan, 500)
    assert length_pad == 512
    assert ev_pos.dtype == torch.int32 and ev_chan.dtype == torch.int8
    assert ev_pos.tolist() == pos.tolist()
    assert ev_chan.tolist() == chan.tolist()
    out = tpk.pileup_counts_kernel(ev_pos, ev_chan, length_pad)
    assert out.dtype == torch.int32 and out.shape == (512, tpk.C_PAD)
    assert int(out.sum()) == 4 and not out[256].any()
    assert out[3, 17] == 2 and out[255, 31] == 1 and out[511, 29] == 1
    before = dict(tpk.launches)
    z = tpk.pileup_counts(np.zeros(0, np.int32), np.zeros(0, np.int32), 77,
                          18, "kernel", "cuda")
    assert z.shape == (77, 18) and z.dtype == np.int32 and not z.any()
    assert tpk.launches == before


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_order_invariance(seed):
    """The same events shuffled with a numpy seed give counts identical to
    the events in the order made, and equal to the JAX XLA version."""
    from clair3_rna_tpu.ops import pileup_kernel as jpk

    make, length, n_ch = CASES["30ch_phased"]
    pos, chan = make()
    perm = np.random.default_rng(seed).permutation(len(pos))
    shuffled = tpk.pileup_counts(pos[perm], chan[perm], length, n_ch,
                                 "kernel", "cpu")
    in_order = tpk.pileup_counts(pos, chan, length, n_ch, "kernel", "cpu")
    np.testing.assert_array_equal(shuffled, in_order)
    np.testing.assert_array_equal(
        shuffled, jpk.pileup_counts_jax(pos, chan, length, n_ch))


def test_inert_events():
    """Events at a negative position, at or beyond length_pad, or with a
    channel outside [0, 32) count nothing: real events mixed with them
    give exactly the numpy oracle's and the JAX XLA version's counts of
    the real events alone (the JAX version would spill an out-of-range
    channel into the next position, so it is not given them)."""
    from clair3_rna_tpu.ops import pileup_kernel as jpk

    pos, chan = _random_events(6, 4000, 700, 32)
    bad_pos = np.array([-1, -77, 768, 5000, 10, 11, 12], np.int32)
    bad_chan = np.array([0, 3, 1, 31, 32, 100, -1], np.int32)
    length_pad = 768
    ev_pos, ev_chan, _ = tpk.prepare(np.concatenate([bad_pos, pos]),
                                     np.concatenate([bad_chan, chan]), 700)
    out = tpk.pileup_counts_plain(ev_pos, ev_chan, length_pad).numpy()
    assert int(out.sum()) == len(pos) and not out[700:].any()
    want = _oracle(pos, chan, 700, 32)
    np.testing.assert_array_equal(out[:700], want)
    np.testing.assert_array_equal(out[:700],
                                  jpk.pileup_counts_jax(pos, chan, 700, 32))


def test_builder_kernel_backend_matches_host_and_jax(tmp_path, monkeypatch):
    """CLAIR3_RNA_TORCH_PILEUP_BACKEND=kernel (and =device) routes the
    pure-array builder's channel counts through ops/pileup_kernel on the
    given device, and the tensor rows equal its host bincount rows and the
    JAX package's device-backend rows (tests/test_pileup_kernel.py:53)."""
    from clair3_rna_torch import simdata
    from clair3_rna_torch.config import PileupConfig
    from clair3_rna_torch.io.fasta import FastaFile
    from clair3_rna_torch.pileup.chunk import (ChunkTask, build_chunk_tensors,
                                               open_bam)
    from clair3_rna_tpu.config import PileupConfig as JCfg
    from clair3_rna_tpu.io.fasta import FastaFile as JFasta
    from clair3_rna_tpu.pileup import chunk as jchunk

    fasta, bam_path, _, _ = simdata.make_dataset(
        tmp_path, seed=33, contig_len=2500, n_variants=6, depth=25)
    task = ChunkTask("chr1", 0, 2500)
    bam = open_bam(bam_path, prefer_native=False)
    calls = []
    orig = tpk.pileup_counts

    def counting(*a, **k):
        calls.append(a[4])
        return orig(*a, **k)

    monkeypatch.setattr(tpk, "pileup_counts", counting)
    rows = {}
    for backend in ("host", "kernel", "device"):
        monkeypatch.setenv("CLAIR3_RNA_TORCH_PILEUP_BACKEND", backend)
        rows[backend] = [r.to_reference_row() for r in build_chunk_tensors(
            bam, FastaFile(fasta), task, PileupConfig(), device="cpu")]
    # base+star, ins/del (when the chunk has any) and the 4 group counts
    assert calls.count("kernel") >= 2
    assert calls.count("kernel") == calls.count("device") == len(calls) // 2

    monkeypatch.setenv("CLAIR3_RNA_TPU_PILEUP_BACKEND", "device")
    jrows = [r.to_reference_row() for r in jchunk.build_chunk_tensors(
        jchunk.open_bam(bam_path, prefer_native=False), JFasta(fasta),
        jchunk.ChunkTask("chr1", 0, 2500), JCfg())]
    assert len(jrows) > 3
    for backend, got in rows.items():
        assert got == jrows, backend


def test_builder_backend_choice(monkeypatch):
    """The builder's backend names: host|device|kernel; the route names the
    same variable carries for caller/backend.py mean the host bincount;
    anything else raises. A device backend with no device given resolves
    to CUDA and raises without a card (no silent CPU fallback)."""
    from clair3_rna_torch.caller.backend import resolve_backend
    from clair3_rna_torch.config import PileupConfig
    from clair3_rna_torch.pileup import builder
    from clair3_rna_torch.pileup.events import extract_events

    for value, want in (("host", "host"), ("device", "device"),
                        ("kernel", "kernel"), ("fused", "host"),
                        ("auto", "host"), ("", "host")):
        monkeypatch.setenv("CLAIR3_RNA_TORCH_PILEUP_BACKEND", value)
        assert builder._pileup_backend() == want, value
    for value in ("device", "kernel"):
        monkeypatch.setenv("CLAIR3_RNA_TORCH_PILEUP_BACKEND", value)
        assert resolve_backend() == "host"
    monkeypatch.setenv("CLAIR3_RNA_TORCH_PILEUP_BACKEND", "pallas")
    with pytest.raises(ValueError, match=r"host\|device\|kernel"):
        builder._pileup_backend()
    if not torch.cuda.is_available():
        monkeypatch.setenv("CLAIR3_RNA_TORCH_PILEUP_BACKEND", "kernel")
        events = extract_events(iter(()), 0, 100)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            builder.build_tile_features(events, np.zeros(100, np.int8),
                                        PileupConfig())


def test_wrapper_rejects_bad_inputs():
    pos, chan = _random_events(5, 100, 300, 18)
    args = list(tpk.prepare(pos, chan, 300)[:2])
    length_pad = 512
    with pytest.raises(TypeError):
        tpk.pileup_counts_kernel(args[0].to(torch.int64), args[1],
                                 length_pad)
    with pytest.raises(ValueError):
        tpk.pileup_counts_kernel(args[0], args[1][:-1], length_pad)
    with pytest.raises(ValueError):
        tpk.pileup_counts_kernel(*args, 300)
    with pytest.raises(ValueError, match="unsupported device"):
        tpk.pileup_counts_kernel(*(a.to("meta") for a in args), length_pad)
    with pytest.raises(ValueError, match="bad count backend"):
        tpk.pileup_counts(pos, chan, 300, 18, "pallas", "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES) + ["deep_32ch", "deep_few",
                                                  "wide"])
def test_kernel_matches_plain_on_card(case):
    """csrc/scatter.cu against the plain version, on shuffled events."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.RandomState(8)
    if case == "deep_32ch":
        # heavy contention on a few columns, every channel id, -1 pads
        pos = np.concatenate([rng.randint(0, 8, 300_000) * 97,
                              np.full(100, -1)]).astype(np.int32)
        chan = rng.randint(0, 32, len(pos)).astype(np.int32)
        length, n_ch = 1000, 32
    elif case == "deep_few":
        # every event on three positions, four channels: the atomics
        # collide all the time
        pos = rng.choice([0, 1, 999], 400_003).astype(np.int32)
        chan = rng.randint(0, 4, len(pos)).astype(np.int32)
        length, n_ch = 1000, 4
    elif case == "wide":
        # 8 M positions: the kernel buckets them in six ranges of 6144
        # 256-position tiles (csrc/scatter.cu RANGE_TILES), the last partial
        length, n_ch = 8_000_000, 4
        edges = np.arange(1, 6) * 6144 * 256
        pos = np.concatenate([rng.randint(0, length, 200_000),
                              rng.choice(edges, 5000)
                              + rng.randint(-3, 3, 5000),
                              [0, length - 1]]).astype(np.int32)
        chan = rng.randint(0, n_ch, len(pos)).astype(np.int32)
    else:
        make, length, n_ch = CASES[case]
        pos, chan = make()
    perm = rng.permutation(len(pos))
    pos, chan = pos[perm], chan[perm]
    ev_pos, ev_chan, length_pad = tpk.prepare(pos, chan, length)
    t = [ev_pos.cuda(), ev_chan.cuda()]
    before = tpk.launches["pileup_counts"]
    k = tpk.pileup_counts_kernel(*t, length_pad)
    assert tpk.launches["pileup_counts"] == before + 1
    p = tpk.pileup_counts_plain(*t, length_pad)
    torch.cuda.synchronize()
    assert torch.equal(k, p)
    valid = pos >= 0
    np.testing.assert_array_equal(
        k[:length, :n_ch].cpu().numpy(),
        _oracle(pos[valid], chan[valid], length, n_ch))
    np.testing.assert_array_equal(
        tpk.pileup_counts(pos, chan, length, n_ch, "kernel", "cuda"),
        _oracle(pos[valid], chan[valid], length, n_ch))
