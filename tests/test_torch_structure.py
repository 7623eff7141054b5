"""Structure of the PyTorch port: what it imports, where it runs, and
that it mirrors the reference's public names.

* no module of ``src/repro_torch`` (nor ``chip_smoke.py``,
  ``tools/torch_autotune.py`` or the ``examples/torch_*.py``) imports
  ``jax`` or anything of the JAX package ``repro``;
* entry points default to the card and refuse to fall back to the CPU;
* the ported modules keep the reference's names, and every file of the
  reference has its port but three stand-ins; the audio family and the
  embeddings frontend run.
"""

import ast
import pathlib

import pytest
import torch

import repro_torch
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import lm, params
from repro_torch.launch import profile_cell
from repro_torch.launch import train as launch_train
from repro_torch.serve import ServeOptions, build_engine
from repro_torch.train import TrainConfig, make_train_step, train_state_init

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
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                          ROOT / "tools/torch_autotune.py"]
    examples = sorted((ROOT / "examples").glob("torch_*.py"))
    assert [p.name for p in examples] == [
        "torch_fault_tolerance_demo.py", "torch_quickstart.py",
        "torch_serve_batch.py", "torch_train_sc_lm.py"]
    files += examples
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
    # the measured cell of the cost tooling
    with pytest.raises(RuntimeError, match="CUDA"):
        profile_cell.measure("qwen2-0.5b", "decode_32k", layers=1, batch=2,
                             seq=16)
    out = profile_cell.measure("qwen2-0.5b", "decode_32k", layers=1,
                               batch=2, seq=16, device="cpu")
    assert out["device"] == "cpu" and out["device_ms"] is None
    assert out["flops"] == out["predicted"]["flops"] > 0


def test_serving_entry_points_default_to_the_card():
    """The default (fixed-slot) engine, its cache and the serve launcher
    take the card unless asked for the CPU."""
    from repro_torch.launch import serve as launch_serve

    cfg = get_smoke_config("qwen2-0.5b")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults take it")
    gen = torch.Generator().manual_seed(0)
    p = params.init_params(lm.lm_param_specs(cfg), gen, "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_engine(p, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_cache(cfg, 2, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_serve.main(["--smoke", "--requests", "1"])
    eng = build_engine(p, cfg, device="cpu")
    assert eng.cache["k"].device.type == "cpu"
    assert eng.cache["k"].shape == (2, 4, 128, 2, 16)


def test_engine_refuses_params_on_another_device():
    cfg = get_smoke_config("qwen2-0.5b")
    gen = torch.Generator().manual_seed(0)
    p = params.init_params(lm.lm_param_specs(cfg), gen, "cpu")
    p = {**p, "embed": {"table": p["embed"]["table"].to("meta")}}
    with pytest.raises(ValueError, match="params lie on"):
        build_engine(p, cfg, ServeOptions(paged=True), device="cpu")


# What ``src/repro/{models,configs}`` has and the port lacks: nothing.
UNPORTED = set()
# The files of ``src/repro`` the port stands in for: a jax-version shim
# (no counterpart needed), the Pallas kernels' references (the port's
# plain versions beside each kernel) and the HLO cost parser (the port
# has no HLO: ``launch/cost_analysis.py``).
STAND_INS = {"compat.py", "kernels/ref.py", "launch/hlo_analysis.py"}


def test_port_tree_mirrors_the_reference_but_the_stand_ins():
    ref = ROOT / "src" / "repro"
    missing = {
        str(p.relative_to(ref)) for p in ref.rglob("*")
        if p.is_file() and "__pycache__" not in p.parts
        and not (PORT / p.relative_to(ref)).exists()
    }
    assert missing == STAND_INS
    assert (PORT / PORT_FILES["launch/hlo_analysis.py"]).exists()


def test_port_mirrors_the_reference_models_and_configs():
    ref = ROOT / "src" / "repro"
    missing = {
        f"{sub}/{p.name}"
        for sub in ("models", "configs")
        for p in (ref / sub).glob("*.py")
        if not (PORT / sub / p.name).exists()
    }
    assert missing == UNPORTED


# The scale-out modules and the dry-run / cost tooling the port holds,
# and the reference's public names each lacks: the port's train step
# enters the sharded SC substrate itself, so the launcher imports
# neither ``sc`` nor ``sc_shard_rules``.  ``hlo_analysis.py`` is
# ``cost_analysis.py`` in the port: the port has no HLO, so its text
# parser (``Instr``, ``analyze_hlo``) and the TPU's ICI rate have no
# counterpart.
SCALE_OUT = {
    "sc/sharded.py": set(),
    "sharding/__init__.py": set(),
    "sharding/rules.py": set(),
    "launch/mesh.py": set(),
    "distributed/__init__.py": set(),
    "distributed/compression.py": set(),
    "train/step.py": set(),
    "checkpoint/ckpt.py": set(),
    "launch/train.py": {"sc", "sc_shard_rules"},
    "launch/specs.py": set(),
    "launch/dryrun.py": set(),
    "launch/hlo_analysis.py": {"Instr", "analyze_hlo", "ICI_BW"},
    "launch/profile_cell.py": set(),
    "configs/base.py": set(),
    "configs/__init__.py": set(),
    "models/params.py": set(),
    "sc/encoding.py": set(),
    # not scale-out: the launch-tile autotuner, every public name
    "sc/autotune.py": set(),
}
# reference modules and names the port holds under another name
PORT_FILES = {"launch/hlo_analysis.py": "launch/cost_analysis.py"}
RENAMED = {"hlo_analysis": "cost_analysis", "HloCost": "StepCost"}
# JAX machinery the reference's modules import by name
JAX_NAMES = {"annotations", "jax", "NamedSharding", "PartitionSpec", "P",
             "partial", "shard_map_compat"}


def _public_names(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
    return {n for n in names if not n.startswith("_")}


@pytest.mark.parametrize("rel", sorted(SCALE_OUT))
def test_port_holds_the_scale_out_modules(rel):
    ref = ROOT / "src" / "repro" / rel
    port = PORT / PORT_FILES.get(rel, rel)
    assert port.exists(), rel
    want = {RENAMED.get(n, n) for n in _public_names(ref)}
    missing = want - _public_names(port)
    missing -= JAX_NAMES
    assert missing == SCALE_OUT[rel]


def test_shapes_abstract_params_and_decode_are_ported():
    """The names the dry-run needs from modules the port already had."""
    from repro_torch.configs import SHAPES, ShapeConfig
    from repro_torch.sc import encoding

    assert set(SHAPES) == {"train_4k", "prefill_32k", "decode_32k",
                           "long_500k"}
    assert all(isinstance(s, ShapeConfig) for s in SHAPES.values())
    assert callable(params.abstract_params) and callable(encoding.decode)


def _smoke_params(cfg):
    gen = torch.Generator().manual_seed(0)
    return params.init_params(lm.lm_param_specs(cfg), gen, "cpu")


def _batch(cfg, b=2, s=8):
    toks = torch.arange(b * s, dtype=torch.int32).reshape(b, s) % cfg.vocab
    return {"inputs": toks, "labels": toks.roll(-1, 1)}


def test_audio_family_is_the_dense_stack():
    """The audio family is the dense stack: the same parameter specs,
    the same loss on the same weights, and it trains and serves."""
    dense = get_smoke_config("qwen2-0.5b").replace(
        param_dtype=torch.float32, act_dtype=torch.float32)
    audio = dense.replace(family="audio")
    assert lm.lm_param_specs(audio) == lm.lm_param_specs(dense)
    p = _smoke_params(dense)
    batch = _batch(dense)
    want = lm.lm_loss(p, batch, dense)
    assert torch.equal(lm.lm_loss(p, batch, audio), want)
    tcfg = TrainConfig()
    state = train_state_init(0, audio, tcfg, device="cpu")
    _, metrics = make_train_step(audio, tcfg)(state, batch)
    assert torch.isfinite(metrics["loss"])
    assert lm.init_paged_cache(audio, 4, 4, device="cpu")["k"].shape[0] == 2
    assert build_engine(p, audio, device="cpu").cfg.family == "audio"


def test_embeddings_frontend_projects_embeddings():
    """``frontend="embeddings"`` adds the frontend's (d, d) projection to
    the specs, and ``encode`` projects (b, s, d) embeddings through it:
    the table's rows under an identity projection give the tokens'
    hidden states.  Token prompts still serve."""
    cfg = get_smoke_config("qwen2-0.5b").replace(
        param_dtype=torch.float32, act_dtype=torch.float32,
        frontend="embeddings")
    proj = lm.lm_param_specs(cfg)["frontend"]["proj"]
    assert (proj.shape, proj.axes, proj.init) == (
        (cfg.d_model, cfg.d_model), ("embed", None), "scaled")
    p = _smoke_params(cfg)
    p["frontend"]["proj"] = torch.eye(cfg.d_model)
    toks = _batch(cfg)["inputs"]
    emb = p["embed"]["table"][toks.long()]
    want = lm.encode(p, toks, cfg)
    assert torch.allclose(lm.encode(p, emb, cfg), want, rtol=0, atol=1e-6)
    assert lm.init_paged_cache(cfg, 4, 4, device="cpu")["k"].shape[0] == 2
    assert build_engine(p, cfg, device="cpu").cfg.frontend == "embeddings"


def test_full_width_config_matches_published_qwen2_0_5b():
    cfg = get_config("qwen2-0.5b")
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads) == (896, 14, 2)
    assert (cfg.d_ff, cfg.vocab, cfg.n_layers) == (4864, 151936, 24)
    assert cfg.resolved_head_dim == 64
    assert cfg.qkv_bias and cfg.tie_embeddings
    assert cfg.param_dtype == cfg.act_dtype == torch.bfloat16
