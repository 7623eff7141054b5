"""The plain reference against the port on the CPU at a small size, its
counter-based RNG against the port's, and a run's comparison with the
timed path broken underneath."""

import json
from pathlib import Path

import pytest
import torch

from perfbench import control, run, trace
from perfbench.drivers import train
from perfbench.ref import rng, ssm_lm
from perfbench.ref import train as ref_train

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
TRAIN = [w["name"] for w in BENCH["workloads"]]
# mamba2-370m's SMOKE sizes in the port (configs/mamba2_370m.py)
SMOKE = {"family": "ssm", "n_layers": 2, "d_model": 64, "ssm_state": 16,
         "ssm_headdim": 16, "ssm_expand": 2, "ssm_conv": 4, "ssm_chunk": 8,
         "vocab": 256, "tie_embeddings": True}


def small_cell(name: str, seed: int = 3000000007, fault=None, **sizes):
    """Cell ``name`` with SMOKE sizes (or ``sizes`` over them) and its
    own limits on the CPU, training on 2 x 32 tokens."""
    cell = run.load_cell(BENCH, name, seed, 0.0, False, torch.device("cpu"))
    cell.config = dict(cell.config, sizes=dict(SMOKE, **sizes))
    cell.mix = dict(cell.mix, seq=32, remat="none")
    cell.fault = fault
    return cell


def tf32(t):
    """``t`` rounded to TF32's 10 mantissa bits, to nearest."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def test_threefry_and_samplers_match_the_port():
    from repro_torch.sc import ctr_rng

    key = ctr_rng.prng_key(3000000007)
    ours = rng.prng_key(3000000007)
    assert torch.equal(ctr_rng.fold_in(key, 5).long(), rng.fold_in(ours, 5))
    assert torch.equal(ctr_rng.normal(key, (3, 130)),
                       rng.normal(ours, (3, 130)))
    keys = ctr_rng.fold_in(key, torch.arange(4))
    assert torch.equal(ctr_rng.normal_rows(keys, 50),
                       rng.normal_rows(keys.long(), 50))


def test_ssd_matches_the_recurrence():
    g = torch.Generator().manual_seed(0)
    b, s, h, p, n = 2, 12, 3, 4, 5
    x = torch.randn(b, s, h, p, generator=g)
    dt = torch.rand(b, s, h, generator=g)
    A = -torch.rand(h, generator=g) - 0.5
    B, C = torch.randn(b, s, n, generator=g), torch.randn(b, s, n, generator=g)
    H = torch.zeros(b, h, n, p)
    want = []
    for t in range(s):
        H = torch.exp(dt[:, t] * A)[..., None, None] * H + \
            (dt[:, t, :, None, None] * B[:, t, None, :, None]
             * x[:, t, :, None, :])
        want.append(torch.einsum("bn,bhnp->bhp", C[:, t], H))
    got = ssm_lm.ssd(x, dt, A, B, C, chunk=4)
    assert torch.allclose(got, torch.stack(want, 1), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("name", TRAIN)
def test_reference_follows_the_port(name, remat):
    """The port's train step (kernel 5's plain version on the CPU) and
    the reference, three steps from the same weights and batches, at the
    SMOKE size: within the cell's limits, the unembed's backward found
    and float32-equal to ``g @ w.T``."""
    cell = small_cell(name)
    cell.mix = dict(cell.mix, remat=remat)
    out = train.run(cell)
    got = {k: v for k, v, _ in out["checks"]}
    assert run.is_correct(out["checks"])
    assert set(got) == set(cell.limits)
    assert got["dx"] < 1e-6


def test_reference_follows_the_port_on_exact_matmuls():
    """A mix on the ``exact`` substrate, which a later cell may bring as
    data alone: the port and the reference float32 rounding apart."""
    cell = small_cell(TRAIN[0])
    cell.mix = dict(cell.mix, sc_backend="exact")
    cell.limits = {"loss": 1e-5, "grad": 1e-4, "change": 1e-3}
    assert run.is_correct(train.run(cell)["checks"])


def test_the_probe_sees_the_first_unembed_call_only():
    """The reference's probe records its first step's unembed call: the
    gradient at the logits, (b x chunk, vocab), and at its input."""
    cell = small_cell(TRAIN[0])
    batches = [train.batch_source(cell)() for _ in range(2)]
    probe = ref_train.UnembedProbe()
    train.reference_readings(cell, batches, probe=probe)
    assert probe.g.shape == (2 * 32, SMOKE["vocab"])
    assert probe.dx.shape == (2 * 32, SMOKE["d_model"])
    assert train.judge_unembed(cell, probe) < 1e-6


def test_an_unembed_backward_in_tf32_is_not_correct():
    """``dx`` from TF32-rounded operands reads past the cell's limit;
    one from float32 does not; one never recorded reads infinite."""
    cell = small_cell(TRAIN[0], d_model=256, vocab=2048)
    w = ssm_lm.unembed_weight(train.make_weights(cell),
                              cell.config["sizes"])
    g = torch.softmax(torch.randn(512, 2048,
                                  generator=torch.Generator().manual_seed(1)),
                      -1) / 512
    probe = ref_train.UnembedProbe()
    assert ref_train.unembed_dx_gap(probe, w) == float("inf")
    probe.g, probe.dx = g, g @ w.T
    assert ref_train.unembed_dx_gap(probe, w) <= cell.limits["dx"] / 10
    probe.dx = tf32(g) @ tf32(w).T
    assert ref_train.unembed_dx_gap(probe, w) > 3 * cell.limits["dx"]


@pytest.mark.parametrize("fault", ["frozen", "half_batch"])
@pytest.mark.parametrize("name", TRAIN)
def test_a_broken_step_is_not_correct(name, fault):
    """A run whose train step is broken underneath reads past the cell's
    limits: one that returns its state unchanged, one that trains on
    half of each batch."""
    out = train.run(small_cell(name, fault=fault))
    assert not run.is_correct(out["checks"])


@pytest.mark.card
@pytest.mark.parametrize("name", TRAIN)
def test_tf32_control_is_not_correct_on_the_card(name, card):
    """The control, the reference with its float32 matmuls in TF32 in
    the program's place, reads past the cell's limits (TF32 exists on
    the card alone)."""
    cell = small_cell(name, d_model=256, vocab=2048)
    cell.device = card
    readings = control.readings(cell, "tf32")
    checks = [(k, readings[k], lim) for k, lim in cell.limits.items()]
    assert not run.is_correct(checks)


def test_idle_gaps_and_busy_time():
    w = trace.Window(ops=[("a", 0.0, 10.0), ("b", 5.0, 20.0),
                          ("a", 50.0, 60.0), ("c", 100.0, 101.0)],
                     host=[("cudaStreamSynchronize", 70.0, 99.0),
                           ("cudaLaunchKernel", 19.0, 21.0)],
                     seconds=200e-6, spans=[], launches={}, info={})
    assert w.busy_s() == pytest.approx(31e-6)
    assert w.device_s("a") == pytest.approx(20e-6)
    assert trace.idle_gaps(w) == [["cudaStreamSynchronize", 40e-6],
                                  ["host", 30e-6]]
    assert trace.top_ops(w, 1) == [["a", 20e-6]]
