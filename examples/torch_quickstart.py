"""Quickstart: the paper's SOT-MRAM stochastic-computing MUL engine in 60
seconds, on the PyTorch/CUDA port.

    PYTHONPATH=src python examples/torch_quickstart.py               # card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Walks the full Eq. 4 pipeline on two operands, shows the error statistics
(paper Fig. 7), then lifts the engine to a matmul through the pluggable
``repro_torch.sc`` backend registry, including an end-to-end LM forward
whose every dense() runs the fused moment kernel.  On the card every
kernel is the port's hand-written CUDA; ``--device cpu`` runs their plain
PyTorch versions.  The keys are the reference's (``ctr_rng.prng_key(0)``
is ``jax.random.PRNGKey(0)``): sections 1 and 2 give the reference
quickstart's MUL and 500-repeat statistics.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch import arch, resolve_device, sc
from repro_torch.configs import get_smoke_config
from repro_torch.core import conversion, engine
from repro_torch.kernels.sc_mul import sc_mul_bitexact
from repro_torch.models import lm, params as params_lib
from repro_torch.sc import ctr_rng

X_INT, Y_INT = 700, 300  # 10-bit operands
REPEATS = 500


def one_mul(key, cfg, device):
    """Section 1's MUL: ``(p_est, product)`` of X_INT * Y_INT."""
    return engine.sc_multiply(key, X_INT, Y_INT, cfg, device=device)


def repeated_muls(key, cfg, device, n: int = REPEATS):
    """Section 2: p_est of the MUL under each of ``split(key, n)``, as
    the reference vmaps it."""
    keys = ctr_rng.split(key, n)
    return torch.stack([engine.sc_multiply(k, X_INT, Y_INT, cfg,
                                           device=device)[0] for k in keys])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    key = ctr_rng.prng_key(0)

    # --- 1. One stochastic MUL: X*Y via two write pulses --------------------
    cfg = engine.EngineConfig(nbit=1024)  # 2^10 MRAM cells per MUL
    tau_x = conversion.operand_to_tau(X_INT, cfg.conv, dev)
    tau_y = conversion.operand_to_tau(Y_INT, cfg.conv, dev)
    print(f"operands {X_INT}, {Y_INT} -> pulse durations "
          f"{float(tau_x):.3f} ns, {float(tau_y):.3f} ns")
    p_est, product = one_mul(key, cfg, dev)
    true = X_INT * Y_INT
    print(f"SC product:    {int(product)}  (true {true}, "
          f"err {abs(int(product) - true) / true * 100:.2f}%)")

    # --- 2. Error statistics (Fig. 7a) ---------------------------------------
    p_true = (X_INT / 1024) * (Y_INT / 1024)
    ests = repeated_muls(key, cfg, dev)
    print(f"{REPEATS} repeats:   mean={float(ests.mean()):.4f} (true "
          f"{p_true:.4f}), sigma={float(ests.std(correction=0)) * 100:.2f}% "
          "— zero-centered Gaussian")

    # --- 3. The engine as a framework matmul: the sc_dot registry ------------
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((8, 256), generator=gen).to(dev)
    w = torch.randn((256, 16), generator=gen).to(dev)
    y_exact = x @ w
    print(f"registered backends: {', '.join(sc.available_backends())}")
    for backend in ("moment", "pallas_moment"):
        sc_cfg = sc.ScConfig(backend=backend, nbit=1024)
        y_sc = sc.sc_dot(key.to(dev), x, w, sc_cfg)
        rel = float((y_sc - y_exact).abs().mean() / y_exact.abs().mean())
        print(f"sc_dot[{backend:>14s}]: mean rel err {rel * 100:.1f}% at "
              "nbit=1024")

    # --- 4. Packed bit-exact engine on raw probabilities ---------------------
    est = sc_mul_bitexact(key, torch.tensor([X_INT / 1024], device=dev),
                          torch.tensor([Y_INT / 1024], device=dev), nbit=2048)
    print(f"packed kernel: p_est={float(est[0]):.4f} (true {p_true:.4f})")

    # --- 5. End-to-end: an LM whose every matmul is the fused moment kernel --
    mcfg = get_smoke_config("paper-sc").replace(
        sc_backend="pallas_moment", param_dtype=torch.float32,
        act_dtype=torch.float32)
    params = params_lib.init_params(lm.lm_param_specs(mcfg), gen, dev,
                                    mcfg.param_dtype)
    toks = ctr_rng.randint(key, (1, 16), 2, mcfg.vocab).to(dev)
    logits = lm.forward(params, toks, mcfg, rng=ctr_rng.prng_key(7).to(dev))
    logits_exact = lm.forward(params, toks, mcfg.replace(sc_backend="exact"))
    drift = float((logits - logits_exact).abs().mean())
    print(f"LM forward:    every dense() via sc_backend={mcfg.sc_backend!r}, "
          f"logits {tuple(logits.shape)}, mean |Δ| vs exact = {drift:.3f}")

    # --- 6. The array-level architecture simulator (repro_torch.arch) --------
    # The same matmul "on hardware": tiled onto banks/subarrays, compiled to
    # a pulse schedule, priced in cycles and picojoules, while the numerics
    # run the bit-exact engine underneath.
    xa = torch.randn((4, 32), generator=gen).to(dev)
    wa = torch.randn((32, 8), generator=gen).to(dev)
    with arch.collect() as records:
        sc.sc_dot(key.to(dev), xa, wa, sc.ScConfig(backend="array",
                                                   nbit=1024))
    rec = records[0]
    rep = rec.report
    print(f"array backend: {rec.plan.products} MULs -> {rec.plan.waves} "
          f"wave(s) on {rec.plan.spec.banks} banks, {rep.cycles} cycles, "
          f"{rep.energy_nj:.1f} nJ, subarray util {rep.subarray_util:.2f}")
    print(arch.format_trace(rec.trace))
    print(f"done on {dev}.")


if __name__ == "__main__":
    main()
