"""PyTorch port vs JAX reference: the launch-tile autotuner.

* The reference's cache semantics run on both packages with the same
  inputs (``tests/test_sc_fused.py`` and ``tests/test_paged_attention.py``
  on the reference): a version bump invalidates, malformed files and
  entries fall back, a miss gives the heuristic, a hit the stored tile,
  the environment variable's path is read, and the kinds stay disjoint.
  The tiles differ (the port's hold the Hopper kernels' knobs), so each
  package is handed tiles of its own.
* The same sequence of hit / miss lookups gives the same
  ``sc_autotune_lookups_total`` series and the same span attributes as
  the reference's (``tests/test_obs.py``).
* With an empty cache every launch of kernels 1-3 has the shape it had
  before the cache existed (the old formulas are copied here), and no
  attention tile moves the splits a row's softmax merges.
* The CLI, with a stubbed timer, writes a cache that ``load_cache``
  reads back; without a GPU it exits non-zero.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro import obs as jobs
from repro.sc import autotune as jat
from repro_torch import obs as tobs
from repro_torch.kernels import paged_attention as tpa
from repro_torch.sc import autotune as tat

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOOL = ROOT / "tools" / "torch_autotune.py"

# Per package: a stored matmul tile and attention tile unlike the
# heuristic's, an entry with a non-positive knob, and the env variable.
PKGS = {
    "reference": dict(
        mod=jat, env="REPRO_SC_AUTOTUNE_CACHE",
        fused=jat.FusedTile(4, 8, 16, 2),
        attn=jat.AttnTile(block_q=4, lane_words=8),
        zero_fused=dict(block_m=0, block_n=8, block_k=32, lane_words=16),
        zero_attn=dict(block_q=0, lane_words=16),
        bad_fused={"block_m": "huge"}, bad_attn={"block_q": "huge"},
    ),
    "port": dict(
        mod=tat, env="REPRO_TORCH_SC_AUTOTUNE_CACHE",
        fused=tat.FusedTile(threads=256, ksplit=3),
        attn=tat.AttnTile(logit_threads=512),
        zero_fused=dict(threads=128, ksplit=0),
        zero_attn=dict(logit_threads=0),
        bad_fused={"threads": "huge"}, bad_attn={"logit_threads": "huge"},
    ),
}
PKG = pytest.mark.parametrize("pkg", sorted(PKGS))

# the CLI's default kernel-1 shapes: chip_smoke.py's phases A, F and S
MAIN_PATH_SHAPES = [(2, 896, 896), (2, 896, 128), (2, 896, 9728),
                    (2, 4864, 896), (2, 896, 151936), (12, 896, 896),
                    (12, 896, 128), (12, 896, 9728), (12, 4864, 896),
                    (1, 896, 151936), (2, 1024, 32)]
# (rows, block, head dim, nbit) of phase A's attention: decode and prefill
MAIN_PATH_ATTN = [(7, 16, 64, 0), (7, 16, 64, 1024), (56, 16, 64, 0),
                  (56, 16, 64, 1024)]


@pytest.fixture(autouse=True)
def _fresh_caches():
    jat.reset_cache()
    tat.reset_cache()
    yield
    jat.reset_cache()
    tat.reset_cache()


@pytest.fixture
def empty_cache(tmp_path, monkeypatch):
    """Point the port's lookups at an empty (valid) cache file."""
    path = str(tmp_path / "empty.json")
    tat.save_cache({}, path)
    monkeypatch.setenv("REPRO_TORCH_SC_AUTOTUNE_CACHE", path)
    tat.reset_cache()
    return path


# ---------------------------------------------------------------------------
# Cache semantics, on both packages
# ---------------------------------------------------------------------------


@PKG
def test_version_bump_invalidates(pkg, tmp_path):
    p = PKGS[pkg]
    mod, path = p["mod"], str(tmp_path / "cache.json")
    entries = {mod.cache_key(8, 32, 8, 1024): p["fused"].kwargs()}
    with open(path, "w") as f:
        json.dump({"version": mod.CACHE_VERSION + 1, "entries": entries}, f)
    assert mod.load_cache(path) == {}
    with open(path, "w") as f:
        json.dump({"version": mod.CACHE_VERSION, "entries": entries}, f)
    assert mod.load_cache(path) == entries


@PKG
def test_malformed_files_and_entries_fall_back(pkg, tmp_path):
    p = PKGS[pkg]
    mod, path = p["mod"], str(tmp_path / "cache.json")
    with open(path, "w") as f:
        f.write("{not json")
    assert mod.load_cache(path) == {}
    assert mod.load_cache(str(tmp_path / "absent.json")) == {}
    key, akey = mod.cache_key(8, 32, 8, 1024), mod.attn_cache_key(8, 16, 64,
                                                                  1024)
    heur = mod.heuristic_tile(8, 32, 8, 1024)
    aheur = mod.heuristic_attn_tile(8, 16, 64, 1024)
    for entry in (p["bad_fused"], p["zero_fused"]):
        assert mod.get_tile(8, 32, 8, 1024, cache={key: entry}) == heur
    for entry in (p["bad_attn"], p["zero_attn"]):
        assert mod.get_attn_tile(8, 16, 64, 1024,
                                 cache={akey: entry}) == aheur


@PKG
def test_miss_gives_the_heuristic_and_a_hit_the_stored_tile(pkg, tmp_path):
    p = PKGS[pkg]
    mod, path = p["mod"], str(tmp_path / "cache.json")
    assert mod.get_tile(13, 40, 7, 1024, cache={}) == \
        mod.heuristic_tile(13, 40, 7, 1024)
    entry = dict(p["fused"].kwargs(), wall_us=12.5)  # extra fields pass
    aentry = dict(p["attn"].kwargs(), wall_us=1.0)
    mod.save_cache({mod.cache_key(8, 32, 8, 1024): entry,
                    mod.attn_cache_key(8, 16, 64, 1024): aentry}, path)
    cache = mod.load_cache(path)
    assert mod.get_tile(8, 32, 8, 1024, cache=cache) == p["fused"]
    assert mod.get_attn_tile(8, 16, 64, 1024, cache=cache) == p["attn"]
    # another signature in the same cache still falls back
    assert mod.get_tile(8, 32, 8, 512, cache=cache) == \
        mod.heuristic_tile(8, 32, 8, 512)
    assert mod.get_attn_tile(8, 16, 64, 512, cache=cache) == \
        mod.heuristic_attn_tile(8, 16, 64, 512)


@PKG
def test_the_environment_variable_names_the_cache(pkg, tmp_path,
                                                  monkeypatch):
    p = PKGS[pkg]
    mod, path = p["mod"], str(tmp_path / "cache.json")
    mod.save_cache({mod.attn_cache_key(6, 4, 16, 128): p["attn"].kwargs(),
                    mod.cache_key(6, 4, 16, 128): p["fused"].kwargs()},
                   path)
    monkeypatch.setenv(p["env"], path)
    mod.reset_cache()
    assert mod.get_attn_tile(6, 4, 16, 128) == p["attn"]
    assert mod.get_tile(6, 4, 16, 128) == p["fused"]


@PKG
def test_kinds_are_disjoint(pkg):
    mod = PKGS[pkg]["mod"]
    ak = mod.attn_cache_key(8, 16, 64, 1024)
    assert ak.startswith("attn|")
    assert ak != mod.cache_key(8, 16, 64, 1024)
    assert mod.attn_cache_key(8, 16, 64, 0) != ak
    # a matmul entry under the attention shape's numbers is no attention hit
    cache = {mod.cache_key(8, 16, 64, 1024): PKGS[pkg]["fused"].kwargs()}
    assert mod.get_attn_tile(8, 16, 64, 1024, cache=cache) == \
        mod.heuristic_attn_tile(8, 16, 64, 1024)


@pytest.fixture
def both_obs():
    """Both packages' default registries on and a tracer installed in
    each, restored after."""
    out = {}
    for name, o in (("reference", jobs), ("port", tobs)):
        reg = o.enable()
        reg.clear()
        out[name] = (reg, o.install_tracer(o.Tracer()))
    yield out
    for name, o in (("reference", jobs), ("port", tobs)):
        reg, tr = out[name]
        o.uninstall_tracer(tr)
        o.disable()
        reg.clear()


def test_lookup_telemetry_matches_the_reference(both_obs):
    """The reference's hit / miss sequence (``tests/test_obs.py``) on both
    packages: the same counter series, and each lookup folds the same
    attribute keys and result into the open span.  The port memoizes
    the shipped cache's lookups, and still counts each one."""
    snaps, spans = {}, {}
    for name, p in PKGS.items():
        mod = p["mod"]
        reg, tr = both_obs[name]
        cache = {mod.cache_key(8, 32, 8, 256): p["fused"].kwargs()}
        results = []
        for call in (
            lambda: mod.get_tile(8, 32, 8, 256, cache=cache),  # hit
            lambda: mod.get_tile(9, 32, 8, 256, cache=cache),  # miss
            lambda: mod.get_attn_tile(8, 4, 8, 0, cache={}),  # attn miss
        ):
            with tr.span("sc.dispatch"):
                call()
            results.append(tr.spans[-1].attrs)
        snaps[name] = reg.snapshot()["counters"]
        spans[name] = results
    assert snaps["port"] == snaps["reference"]
    assert snaps["port"] == {
        "sc_autotune_lookups_total{kind=matmul,result=hit}": 1,
        "sc_autotune_lookups_total{kind=matmul,result=miss}": 1,
        "sc_autotune_lookups_total{kind=attn,result=miss}": 1,
    }
    for got, want in zip(spans["port"], spans["reference"]):
        assert set(got) == set(want) == {"sc_autotune", "sc_tile"}
        assert got["sc_autotune"] == want["sc_autotune"]


def test_memoized_lookups_count_every_call_and_follow_reset(
        tmp_path, monkeypatch):
    path = str(tmp_path / "cache.json")
    first, second = tat.FusedTile(64, 2), tat.FusedTile(256, 1)
    tat.save_cache({tat.cache_key(2, 64, 8, 1024): first.kwargs()}, path)
    monkeypatch.setenv("REPRO_TORCH_SC_AUTOTUNE_CACHE", path)
    reg = tobs.enable()
    reg.clear()
    try:
        assert tat.get_tile(2, 64, 8, 1024) == first
        tat.save_cache({tat.cache_key(2, 64, 8, 1024): second.kwargs()},
                       path)
        assert tat.get_tile(2, 64, 8, 1024) == first  # memoized
        tat.reset_cache()
        assert tat.get_tile(2, 64, 8, 1024) == second
        series = "sc_autotune_lookups_total{kind=matmul,result=hit}"
        assert reg.snapshot()["counters"][series] == 3
    finally:
        tobs.disable()
        reg.clear()


# ---------------------------------------------------------------------------
# The heuristics are the launches the kernels took before the cache
# ---------------------------------------------------------------------------


def _old_k_split(m, k, n, sms=132):
    """``kernels/sc_fused.py:_k_split`` as it stood, at 128 threads."""
    tiles = m * -(-n // 128)
    want = max(1, min(k, -(-16 * sms // tiles)))
    chunk = -(-k // want)
    return -(-k // chunk)


def _old_plan(b, kvh, rows, sc, hd, nb, bs, nbit=0):
    """``kernels/paged_attention.py:paged_attention_plan`` as it stood
    (``ROW_TILE = 16``, ``MAX_LOGIT_THREADS = 256``)."""
    splits = min(nb, -(-132 // (b * kvh)))
    per = -(-nb // splits)
    threads = 0
    if nbit:
        pairs = hd * (nbit // 32)
        threads = min(256, max(32, -(-pairs // 32) * 32))
    return dict(b=b, kvh=kvh, rows=rows, sc=sc, nb=nb, bs=bs,
                row_tiles=-(-rows // 16), pages_per_split=per,
                splits=-(-nb // per), logit_threads=threads)


@pytest.mark.parametrize("m,k,n", MAIN_PATH_SHAPES + [(3, 37, 300),
                                                      (8, 2048, 2816)])
def test_empty_cache_gives_kernel_1_todays_launch(empty_cache, m, k, n):
    want = tat.FusedTile(threads=128, ksplit=_old_k_split(m, k, n))
    assert tat.heuristic_tile(m, k, n, 1024, sms=132) == want
    assert tat.get_tile(m, k, n, 1024, sms=132) == want
    cands = tat.candidate_tiles(m, k, n, 1024, sms=132)
    assert want in cands and len(cands) <= 13
    assert all(t.threads in tat.FUSED_THREADS and 1 <= t.ksplit <= k
               for t in cands)


_PLANS = [
    # (b, kvh, rows, sc, hd, nb, bs, nbit): phase A's decode and prefill,
    # a 1,024-token cache, a verify chunk, small odd shapes
    (2, 2, 7, 1, 64, 4, 16, 1024), (2, 2, 56, 8, 64, 4, 16, 1024),
    (2, 2, 7, 1, 64, 4, 16, 0), (2, 2, 56, 8, 64, 4, 16, 0),
    (2, 2, 7, 1, 64, 64, 16, 1024), (2, 2, 21, 3, 64, 64, 16, 0),
    (3, 2, 12, 3, 8, 3, 4, 64), (1, 2, 40, 5, 64, 40, 4, 0),
    (2, 16, 8, 8, 128, 2, 16, 1024), (1, 32, 1, 1, 112, 2, 16, 1024),
]


@pytest.mark.parametrize("shape", _PLANS)
def test_empty_cache_gives_the_attention_kernels_todays_plan(empty_cache,
                                                             shape):
    b, kvh, rows, sc, hd, nb, bs, nbit = shape
    want = _old_plan(*shape)
    heur = tat.heuristic_attn_tile(rows, bs, hd, nbit)
    for plan in (tpa.paged_attention_plan(*shape),
                 tpa.paged_attention_plan(*shape, dtype="bfloat16"),
                 tpa.paged_attention_plan(*shape, tile=heur)):
        assert dataclasses.asdict(plan) == want


def test_the_plan_looks_the_tile_up_under_qs_dtype(tmp_path, monkeypatch):
    """The wrappers name q's dtype (``dtype_name``): a bfloat16 entry
    moves the bfloat16 launch alone."""
    assert tat.dtype_name(torch.bfloat16) == "bfloat16"
    assert tat.dtype_name(torch.float32) == "float32"
    path = str(tmp_path / "cache.json")
    tat.save_cache({tat.attn_cache_key(7, 16, 64, 1024, "bfloat16"):
                    tat.AttnTile(512).kwargs()}, path)
    monkeypatch.setenv("REPRO_TORCH_SC_AUTOTUNE_CACHE", path)
    tat.reset_cache()
    shape = (2, 2, 7, 1, 64, 4, 16, 1024)
    assert tpa.paged_attention_plan(*shape, dtype="bfloat16") \
        .logit_threads == 512
    assert tpa.paged_attention_plan(*shape).logit_threads == \
        tat.HEURISTIC_LOGIT_THREADS


@pytest.mark.parametrize("rows,bs,hd,nbit", MAIN_PATH_ATTN + [
    (12, 4, 8, 64), (40, 4, 64, 0), (8, 16, 128, 1024), (1, 16, 112, 1024)])
def test_no_attention_tile_moves_the_splits(rows, bs, hd, nbit):
    """Every candidate: the splits and pages a split are the heuristic's
    (they fix the float merge), and so is every pass's work."""
    heur = tat.heuristic_attn_tile(rows, bs, hd, nbit)
    cands = tat.candidate_attn_tiles(rows, bs, hd, nbit)
    assert heur in cands and len(cands) <= 6
    for nb, b, kvh in ((4, 2, 2), (64, 2, 2), (3, 3, 2)):
        sc = 1
        lengths = [nb * bs - 1 - 3 * i for i in range(b)]
        base = tpa.paged_attention_plan(b, kvh, rows, sc, hd, nb, bs, nbit,
                                        tile=heur)
        for tile in cands:
            assert (tile.logit_threads == 0) == (nbit == 0)
            plan = tpa.paged_attention_plan(b, kvh, rows, sc, hd, nb, bs,
                                            nbit, tile=tile)
            assert (plan.splits, plan.pages_per_split, plan.row_tiles) == \
                (base.splits, base.pages_per_split, base.row_tiles)
            assert plan.logit_threads == tile.logit_threads
            assert plan.launches == base.launches
            assert plan.live_blocks(lengths) == base.live_blocks(lengths)


def test_the_shipped_cache_holds_measured_tiles_the_kernels_take():
    """Every shipped entry parses into a launch the kernels take (a hit),
    and records its µs and the card it was measured on; phase A's
    bfloat16 SC decode has its entry."""
    entries = tat.load_cache(tat.DEFAULT_CACHE_PATH)
    assert tat.attn_cache_key(7, 16, 64, 1024, "bfloat16") in entries
    with open(tat.DEFAULT_CACHE_PATH) as f:
        assert json.load(f)["version"] == tat.CACHE_VERSION
    for key, entry in entries.items():
        assert entry["wall_us"] > 0 and entry["card"]
        shape, nbit, dtype = key.removeprefix("attn|").split("|")
        a, b_, c = (int(v) for v in shape.split("x"))
        nbit = int(nbit.removeprefix("nbit="))
        dtype = dtype.removeprefix("dtype=")
        if key.startswith("attn|"):
            tile = tat.get_attn_tile(a, b_, c, nbit, dtype, cache=entries)
            assert tile == tat.AttnTile(entry["logit_threads"])
        else:
            tile = tat.get_tile(a, b_, c, nbit, cache=entries)
            assert tile == tat.FusedTile(entry["threads"], entry["ksplit"])


def _fake_profiler(monkeypatch, traces):
    """``torch.profiler.profile`` handing out ``traces`` in turn, each a
    list of (kernel name, µs) device records; ``synchronize`` a no-op."""
    import torch.profiler

    class Range:
        def __init__(self, us):
            self.us = us

        def elapsed_us(self):
            return self.us

    class Event:
        device_type = torch.autograd.DeviceType.CUDA
        is_user_annotation = False

        def __init__(self, name, us):
            self.name, self.time_range = name, Range(us)

    class Profile:
        def __init__(self, **kw):
            self.trace = traces.pop(0)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return [Event(n, us) for n, us in self.trace]

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)


def test_device_us_sums_each_kernels_mean_over_the_records_kept(
        monkeypatch):
    """4 calls of 2 kernels: a dropped record leaves the other records'
    mean; a trace missing a kernel, or keeping under half of one's
    launches, is taken again, and after three such traces it raises."""
    split, comb = "paged_attn_split_kernel<float, false>", "paged_attn_comb"
    full = [(split, 10.0), (comb, 2.0)] * 4
    dropped = [(split, 10.0), (comb, 2.0), (comb, 4.0), (split, 12.0),
               (comb, 3.0), (split, 11.0), ("other_kernel", 99.0)]
    sparse = [(split, 10.0), (comb, 2.0)]
    _fake_profiler(monkeypatch, [full, dropped, [(split, 1.0)] * 4, sparse,
                                 full])
    calls = []
    us = tat.device_us(lambda: calls.append(1), 2, "paged_attn_", iters=3,
                       reps=4)
    # samples: 12.0, 11.0 + 3.0 = 14.0, then two refused traces and 12.0
    assert us == 12.0
    assert len(calls) == 1 + 4 * 5
    _fake_profiler(monkeypatch, [[(split, 1.0)] * 4] * 3)
    with pytest.raises(RuntimeError, match="2 a call expected"):
        tat.device_us(lambda: None, 2, "paged_attn_", iters=1, reps=4)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def _load_tool():
    import importlib.util

    spec = importlib.util.spec_from_file_location("torch_autotune", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cli_writes_a_cache_that_load_cache_reads(tmp_path, monkeypatch):
    """With a stubbed card and timer: the fastest candidate of each shape
    lands in the file with its µs, the heuristic's and the card's name,
    unless it beats the heuristic by less than ``MIN_GAIN``."""
    tool = _load_tool()
    props = type("Props", (), {"multi_processor_count": 132})()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "stub")
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i=0: props)

    def fused_us(m, k, n, nbit, tile, **kw):
        return 100.0 + abs(tile.threads - 64) + tile.ksplit

    def attn_us(rows, bs, hd, nbit, tile, dtype="float32", **kw):
        if dtype == "float32":  # every other tile 1 % faster: the spread
            return 100.0 - (tile.logit_threads != 256)
        return 10.0 + tile.logit_threads / 64

    monkeypatch.setattr(tat, "measure_tile", fused_us)
    out = str(tmp_path / "cache.json")
    seen = []
    monkeypatch.setattr(tat, "measure_attn_tile",
                        lambda *a, **kw: seen.append(kw) or attn_us(*a, **kw))
    rc = tool.main(["--shapes", "2x896x128", "12x64x32", "--attn-shapes",
                    "7x16x64@15,11", "--out", out, "--quiet", "--iters",
                    "1"])
    assert rc == 0
    entries = tat.load_cache(out)
    assert set(entries) == {
        tat.cache_key(2, 896, 128, 1024), tat.cache_key(12, 64, 32, 1024),
        *(tat.attn_cache_key(7, 16, 64, nbit, dtype) for nbit in (0, 1024)
          for dtype in ("bfloat16", "float32"))}
    for key, entry in entries.items():
        assert entry["card"] == "stub" and entry["wall_us"] > 0
    e = entries[tat.cache_key(2, 896, 128, 1024)]
    cands = tat.candidate_tiles(2, 896, 128, 1024, 132)
    best = min(cands, key=lambda t: fused_us(0, 0, 0, 0, t))
    assert (e["threads"], e["ksplit"]) == (best.threads, best.ksplit)
    heur = tat.heuristic_tile(2, 896, 128, 1024)
    assert e["heuristic_us"] == fused_us(0, 0, 0, 0, heur)
    a = entries[tat.attn_cache_key(7, 16, 64, 1024, "bfloat16")]
    assert a["logit_threads"] == 64
    # a gain under MIN_GAIN keeps the heuristic
    a = entries[tat.attn_cache_key(7, 16, 64, 1024)]
    assert a["logit_threads"] == tat.HEURISTIC_LOGIT_THREADS
    assert a["wall_us"] == a["heuristic_us"] == 100.0
    assert entries[tat.attn_cache_key(7, 16, 64, 0)]["logit_threads"] == 0
    assert tat.get_attn_tile(7, 16, 64, 1024, "bfloat16", cache=entries) \
        == tat.AttnTile(64)
    assert seen and all(kw["lengths"] == [15, 11] and
                        kw["heads"] == (14, 2) for kw in seen)
    assert {kw["dtype"] for kw in seen} == {"bfloat16", "float32"}
    with pytest.raises(SystemExit, match="lengths"):
        tool.main(["--attn-shapes", "7x16x64@a", "--out", out])


def test_cli_without_a_gpu_exits_non_zero(tmp_path):
    out = tmp_path / "cache.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, str(TOOL), "--shapes", "2x8x8", "--out", str(out)],
        capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr
    assert not out.exists()
