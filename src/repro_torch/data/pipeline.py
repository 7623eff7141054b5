"""Deterministic, host-sharded synthetic LM data pipeline.

Port of ``repro.data.pipeline``.  Every batch is a pure function of
``(seed, step, shard)`` through the counter-based Threefry samplers of
``sc/ctr_rng.py``, which reproduce ``jax.random``'s ``uniform``,
``bernoulli`` and ``randint``: no state to checkpoint beyond the step
counter, and any host can regenerate any shard.  Batches are made on
the host (CPU tensors); the train step moves them to the parameters'
device.

The stream is structured so losses move: Zipf-distributed tokens, each
repeating its predecessor half the time, with a BOS every
``max(s // 4, 8)`` positions from a random offset per row.  Labels are
the inputs shifted left; the last target wraps to BOS.
:func:`make_embedding_batch` is the embeddings-frontend variant: frame
embeddings in place of the inputs, the same labels.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.sc import ctr_rng

BOS = 1


@dataclasses.dataclass(frozen=True)
class SyntheticLMData:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1  # data-parallel hosts
    zipf_a: float = 1.2  # token frequency skew

    @property
    def shard_batch(self) -> int:
        if self.global_batch % self.n_shards:
            raise ValueError(
                f"global_batch {self.global_batch} does not split over "
                f"{self.n_shards} shards"
            )
        return self.global_batch // self.n_shards

    def batch(self, step: int, shard: int = 0):
        return make_batch(self, step, shard)


def _zipf_tokens(key, shape, vocab: int, a: float):
    """Zipf-ish token draw: inverse-CDF on u^a, avoiding specials 0/1."""
    u = ctr_rng.uniform(key, shape, 1e-6, 1.0)
    ranks = torch.floor((vocab - 2) * u**a).to(torch.int32)
    return torch.clamp(ranks + 2, 2, vocab - 1)


def make_batch(cfg: SyntheticLMData, step: int, shard: int = 0):
    """``{"inputs": (b, s) int32, "labels": (b, s) int32}`` for one
    shard, on the CPU."""
    key = ctr_rng.fold_in(
        ctr_rng.fold_in(ctr_rng.prng_key(cfg.seed), step), shard
    )
    kt, kd, kr = ctr_rng.split(key, 3)
    b, s = cfg.shard_batch, cfg.seq_len
    toks = _zipf_tokens(kt, (b, s), cfg.vocab, cfg.zipf_a)
    # token t repeats t-1 half the time: signal for the model to learn
    repeat = ctr_rng.bernoulli(kr, 0.5, (b, s))
    toks = torch.where(repeat, torch.roll(toks, 1, dims=1), toks)
    doc_len = max(s // 4, 8)
    offsets = ctr_rng.randint(kd, (b, 1), 0, doc_len)
    pos = torch.arange(s)[None, :]
    is_bos = (pos + offsets) % doc_len == 0
    inputs = torch.where(is_bos, BOS, toks).to(torch.int32)
    labels = torch.roll(inputs, -1, dims=1)
    labels[:, -1] = BOS
    return {"inputs": inputs, "labels": labels}


def make_embedding_batch(cfg: SyntheticLMData, d_model: int, step: int,
                         shard: int = 0, dtype=torch.float32):
    """``{"inputs": (b, s, d_model) dtype, "labels": (b, s) int32}``: the
    labels are :func:`make_batch`'s, the inputs ``normal(fold_in(
    fold_in(PRNGKey(seed ^ 0x5EED), step), shard)) · 0.02`` precomputed
    frame embeddings, on the CPU."""
    labels = make_batch(cfg, step, shard)["labels"]
    key = ctr_rng.fold_in(
        ctr_rng.fold_in(ctr_rng.prng_key(cfg.seed ^ 0x5EED), step), shard
    )
    shape = (cfg.shard_batch, cfg.seq_len, d_model)
    emb = (ctr_rng.normal(key, shape) * 0.02).to(dtype)
    return {"inputs": emb, "labels": labels}
