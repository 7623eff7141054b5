"""Structure of the PyTorch port: what it imports, where it runs, and
that it mirrors the reference's public names.

* no module of ``src/repro_torch`` (nor ``chip_smoke.py``) imports
  ``jax`` or anything of the JAX package ``repro``;
* entry points default to the card and refuse to fall back to the CPU;
* the ported modules keep the reference's names.
"""

import ast
import pathlib

import pytest
import torch

import repro_torch
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import lm, params
from repro_torch.launch import train as launch_train
from repro_torch.serve import ServeOptions, build_engine
from repro_torch.train import TrainConfig, train_state_init

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_and_nothing_of_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = []
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "repro", "flax"):
                bad.append(f"{path.relative_to(ROOT)}: {mod}")
    assert not bad, bad


def test_kernel_sources_ship_with_the_package():
    names = {p.name for p in (PORT / "csrc").iterdir()}
    assert {
        "sc_device.cuh",
        "sc_fused.cu",
        "paged_attention.cu",
        "sc_mac.cu",
        "sc_mul.cu",
    } <= names


def test_entry_points_default_to_the_card():
    cfg = get_smoke_config("qwen2-0.5b")
    gen = torch.Generator().manual_seed(0)
    specs = lm.lm_param_specs(cfg)
    if torch.cuda.is_available():
        assert repro_torch.resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        params.init_params(specs, gen)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_paged_cache(cfg, 4, 4)
    p = params.init_params(specs, gen, "cpu", cfg.param_dtype)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_engine(p, cfg, ServeOptions(paged=True))
    eng = build_engine(p, cfg, ServeOptions(paged=True), device="cpu")
    assert eng.pages["k"].device.type == "cpu"
    assert eng.pages["k"].dtype == torch.bfloat16
    # the trainer's entry points
    with pytest.raises(RuntimeError, match="CUDA"):
        train_state_init(0, cfg, TrainConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--arch", "paper-sc", "--smoke", "--steps", "1"])
    state = train_state_init(0, cfg, TrainConfig(), device="cpu")
    assert state["params"]["embed"]["table"].device.type == "cpu"


def test_engine_refuses_params_on_another_device():
    cfg = get_smoke_config("qwen2-0.5b")
    gen = torch.Generator().manual_seed(0)
    p = params.init_params(lm.lm_param_specs(cfg), gen, "cpu")
    p = {**p, "embed": {"table": p["embed"]["table"].to("meta")}}
    with pytest.raises(ValueError, match="params lie on"):
        build_engine(p, cfg, ServeOptions(paged=True), device="cpu")


def test_unported_families_raise_not_implemented():
    cfg = get_smoke_config("qwen2-0.5b").replace(family="moe")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        lm.lm_param_specs(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        lm.init_paged_cache(cfg, 4, 4, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        lm.encode({}, torch.zeros((1, 2), dtype=torch.int32), cfg)


def test_full_width_config_matches_published_qwen2_0_5b():
    cfg = get_config("qwen2-0.5b")
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads) == (896, 14, 2)
    assert (cfg.d_ff, cfg.vocab, cfg.n_layers) == (4864, 151936, 24)
    assert cfg.resolved_head_dim == 64
    assert cfg.qkv_bias and cfg.tie_embeddings
    assert cfg.param_dtype == cfg.act_dtype == torch.bfloat16
