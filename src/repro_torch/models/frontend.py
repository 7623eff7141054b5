"""Stub modality frontends: the backbone takes precomputed frame / patch
embeddings (audio) or early-fusion token ids (vlm).

Port of ``repro.models.frontend``:

* musicgen-large: the EnCodec tokenizer and codebook interleaving are
  not modelled; inputs are per-frame embeddings (batch, frames,
  d_model), projected into the residual stream by one SC-routed matmul.
* chameleon-34b: VQ-GAN image tokens are ordinary ids in the text
  vocabulary, so inputs stay token ids; the stub marks the image span.

The draws take an explicit raw key and device: they are
``sc/ctr_rng.py``'s counter-based samplers, so one key gives the
reference's ``jax.random`` values on any device.
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.models import layers
from repro_torch.models.params import ParamSpec
from repro_torch.sc import ctr_rng


def frontend_specs(cfg):
    """Learned output projection of the embeddings frontend: one
    (d_model, d_model) matmul site, so multimodal inputs reach the SC
    substrate from the first layer."""
    d = cfg.d_model
    return {"proj": ParamSpec((d, d), ("embed", None), "scaled")}


def project_embeddings(x, p, cfg, key=None):
    """Frontend embeddings (b, s, d) through the output projection on the
    configured substrate (site ``frontend_proj``); ``key`` is the
    caller's rng root."""
    return layers.dense(x, p["proj"], cfg,
                        layers.site_key(key, "frontend_proj"),
                        site="frontend_proj")


def audio_frame_embeddings(key, batch: int, frames: int, d_model: int,
                           dtype=torch.bfloat16, *, device=None):
    """Stand-in for the EnCodec front end: ``normal(key) · 0.02`` frame
    embeddings (batch, frames, d_model) in ``dtype``."""
    device = resolve_device(device)
    z = ctr_rng.normal(key, (batch, frames, d_model), device=device)
    return (z * 0.02).to(dtype)


def vq_token_ids(key, batch: int, seq: int, vocab: int,
                 image_span: tuple = (16, 272), *, device=None):
    """Early-fusion token stream: ``(ids, modality)``, both (batch, seq)
    int32, the modality 1 over the image span ``[lo, min(hi, seq))``."""
    device = resolve_device(device)
    toks = ctr_rng.randint(key, (batch, seq), 0, vocab, device=device)
    modality = torch.zeros((batch, seq), dtype=torch.int32, device=device)
    lo, hi = image_span
    modality[:, lo:min(hi, seq)] = 1
    return toks, modality
