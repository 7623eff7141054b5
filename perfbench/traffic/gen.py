"""The one generator every traffic mix of the benchmark draws from.

A mix is a data file beside this one; a driver hands its parameters to
these functions with a ``torch.Generator`` seeded from ``--seed``, so
one seed gives the same inputs on every run.

``lm_batch`` is a frozen copy of the program's synthetic language-model
stream (``data/pipeline.py``), drawn on the device: Zipf-skewed tokens
(inverse CDF on ``u**a``, ids 0 and 1 kept for padding and BOS), each
repeating its predecessor half the time so that a loss can fall, and a
BOS every ``max(seq // 4, 8)`` positions from a random offset per row.
Labels are the inputs shifted left, the last one BOS.
"""

from __future__ import annotations

import torch

BOS = 1


def zipf_tokens(gen, shape, vocab: int, a: float) -> torch.Tensor:
    """int64 ids in ``[2, vocab)``, rank ``floor((vocab - 2) * u**a)``
    for ``u`` uniform on ``[1e-6, 1)``."""
    u = torch.rand(shape, generator=gen, device=gen.device)
    u = 1e-6 + u * (1.0 - 1e-6)
    ranks = torch.floor((vocab - 2) * u ** a).to(torch.int64)
    return torch.clamp(ranks + 2, 2, vocab - 1)


def lm_batch(gen, batch: int, seq: int, vocab: int, zipf_a: float) -> dict:
    """``{"inputs", "labels"}``: (batch, seq) int32 on the generator's
    device."""
    dev = gen.device
    toks = zipf_tokens(gen, (batch, seq), vocab, zipf_a)
    repeat = torch.rand((batch, seq), generator=gen, device=dev) < 0.5
    toks = torch.where(repeat, torch.roll(toks, 1, dims=1), toks)
    doc = max(seq // 4, 8)
    offsets = torch.randint(0, doc, (batch, 1), generator=gen, device=dev)
    pos = torch.arange(seq, device=dev)[None]
    inputs = torch.where((pos + offsets) % doc == 0, BOS, toks)
    labels = torch.roll(inputs, -1, dims=1)
    labels[:, -1] = BOS
    return {"inputs": inputs.to(torch.int32),
            "labels": labels.to(torch.int32)}
