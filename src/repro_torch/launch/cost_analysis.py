"""Per-rank FLOP / byte / collective / memory account of one traced step.

Counterpart of ``repro.launch.hlo_analysis``.  The reference lowers a
step to HLO and walks the per-device module text; the port has no HLO,
so it traces its own eager step functions on ``meta`` tensors instead
(``launch/dryrun.py``): nothing is allocated and nothing runs, as the
reference lowers without executing.  :class:`CostCounter`, a
``TorchDispatchMode``, sees every aten op of the step (forward,
activation recompute, backward and optimizer) and records:

* **matmul FLOPs**: by ``torch.utils.flop_counter.FlopCounterMode``'s
  own formulas (``flop_registry``: ``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, convolutions, ``einsum``'s ``bmm``), split by the
  operands' dtype (``flops_by_dtype``), since bf16 runs on the tensor
  cores and float32 on the CUDA cores.  ``FlopCounterMode`` itself does
  not run in the trace (the counter's memo answers an op before a mode
  beneath it sees it, and a mode above it doubles the trace's time);
  its count of the same step run for real equals this one (the tests,
  and ``profile_cell.measure`` on the card);
* **bytes**: each aten op is charged its tensor operands plus its output,
  once each.  Eager PyTorch writes every op's output to device memory,
  where the reference's byte model assumes TPU fusion, so this is the
  traffic the port really makes, op by op.  Views and metadata ops
  (``view``, ``expand``, ``permute``, ``empty``, ...) charge nothing; a
  gather (``embedding``, ``index_select``, ``gather``, ``index``) reads
  only the elements it gathers; an in-place write that does not read its
  destination (``copy_``, ``fill_``, ``zero_``) or writes only some of it
  (``index_put_``) is charged what it writes.  ``bytes_by_op`` keeps the
  sum per aten op;
* **peak live bytes**: every storage the step touches (its arguments
  first) is counted from its first appearance until a weakref finalizer
  sees it freed, so the peak is the eager program's, autograd's saved
  tensors and the optimizer's new state included;
* **collectives**: what the step ran on its
  :class:`~repro_torch.launch.mesh.RecordingMesh` (``all_reduce``,
  ``all_gather`` and ``reduce_scatter`` record ``(kind, axis, operand
  bytes)``: under the FSDP layout each layer's gathers and each
  gradient's reduce-scatter; under the sequence layouts each layer's
  sequence gathers and the decode's combine; under the in-layer layout
  its gathers and sums), by kind, by (kind, operand bytes), by mesh
  axis and by site (``coll_by_site``: an all-gather's span name,
  ``mesh.all_gather`` for a parameter's, ``seq.all_gather`` for a
  sequence block's, ``seq.combine`` for the attention partials',
  ``tp.gather`` / ``tp.sum`` / ``tp.vocab`` for the in-layer layout's
  blocks, sums and the loss's vocabulary reductions; else the kind).

The roofline keeps the reference's names and meanings, at an NVIDIA
H100 SXM's rates: the matmul FLOPs over the tensor-core (bf16) or CUDA-
core (float32: the port runs with TF32 off, torch's default) rate, the
bytes over HBM's, and each axis's collective bytes over that axis's link
rate (NVLink within a node of 8 cards, InfiniBand across nodes).
"""

from __future__ import annotations

import dataclasses
import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.models import lm
from repro_torch.models.params import ParamSpec, _leaves

# NVIDIA H100 SXM 80GB HBM3 at its 700 W limit.  The compute rates are
# taken at the card's max SM clock of 1,980 MHz over its 132 SMs, as
# chip_smoke.py's kernel bounds are: 4,096 dense bf16 tensor-core flops
# an SM a clock (the datasheet's 989 TFLOP/s at ~1.83 GHz) and 128 FP32
# FMA lanes (256 flops) an SM a clock.
SM_CLOCK_HZ = 1.98e9
SMS = 132
PEAK_FLOPS_BF16 = SMS * 4096 * SM_CLOCK_HZ  # 1,070.5 TFLOP/s
PEAK_FLOPS_FP32 = SMS * 256 * SM_CLOCK_HZ  # 66.9 TFLOP/s
HBM_BW = 3.35e12  # B/s (H100 SXM datasheet)
# Interconnect, from NVIDIA's data sheets; one card cannot measure them.
# NVLink 4: 900 GB/s a card, 450 GB/s each way (H100 SXM datasheet);
# InfiniBand NDR: one 400 Gb/s ConnectX-7 port a card, 50 GB/s each way
# (DGX H100 datasheet: 8 ports for 8 cards).
NVLINK_BW = 450e9
IB_BW = 50e9
GPUS_PER_NODE = 8

# the matmul rate of each operand dtype (TF32 off, as the port runs)
MATMUL_RATES = {
    "bf16": PEAK_FLOPS_BF16,
    "f16": PEAK_FLOPS_BF16,
    "f32": PEAK_FLOPS_FP32,
}

_DTYPE_NAMES = {
    torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32",
    torch.float64: "f64", torch.int8: "s8", torch.int32: "s32",
    torch.int64: "s64", torch.uint8: "u8", torch.bool: "pred",
}

_aten = torch.ops.aten
# ops that move no data: metadata, allocation without a write
_FREE = {
    _aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
    _aten.new_empty_strided, _aten.detach, _aten.alias, _aten._unsafe_view,
    _aten.lift_fresh, _aten._local_scalar_dense,
}
# gathers: the source is read only where gathered (indices + 2 x output)
_GATHERS = {_aten.embedding, _aten.index_select, _aten.gather,
            _aten.index}
# in-place writes that do not read their destination (inputs but the
# first + the output)
_WRITE_ONLY = {_aten.copy_, _aten.fill_, _aten.zero_}
# in-place scatters: indices and values read, the values written
_SCATTERS = {_aten.index_put_, _aten._index_put_impl_}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _unique_tensors(tree) -> list:
    """The tensors in nested tuples / lists / dicts, each once (a loop,
    not a recursive closure: a closure cycle would hold the tensors until
    the garbage collector runs, and the peak would count them)."""
    out, stack, seen = [], [tree], set()
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if id(x) not in seen:
                seen.add(id(x))
                out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
    return out


def _meta_key(a):
    """A hashable stand-in for an op argument, or raise TypeError."""
    if isinstance(a, torch.Tensor):
        if a.device.type != "meta":
            raise TypeError("not a meta tensor")
        return ("T", tuple(a.shape), a.stride(), a.dtype,
                a.storage_offset())
    if isinstance(a, (list, tuple)):
        return (type(a).__name__,) + tuple(_meta_key(x) for x in a)
    if a is None or isinstance(a, (bool, int, float, str, torch.dtype,
                                   torch.device, torch.layout,
                                   torch.memory_format)):
        return (type(a).__name__, a)
    raise TypeError(type(a).__name__)


def _memo_key(func, args, kwargs):
    """The memo key of a functional op on meta tensors (None where the
    op is a view, mutates, or takes something unhashable)."""
    schema = func._schema
    if func.is_view or schema.is_mutable or any(
            r.alias_info is not None for r in schema.returns):
        return None
    try:
        return (func, _meta_key(args),
                _meta_key(tuple(sorted(kwargs.items()))))
    except TypeError:
        return None


def op_bytes(func, ins, outs) -> int:
    """The bytes one aten op is charged (see the module doc): ``ins`` its
    tensor operands, ``outs`` its tensor outputs, each once."""
    packet = func._overloadpacket
    if func.is_view or packet in _FREE:
        return 0
    if packet in _GATHERS:
        return sum(map(_nbytes, ins[1:])) + 2 * sum(map(_nbytes, outs))
    if packet in _SCATTERS:
        return sum(map(_nbytes, ins[1:])) + _nbytes(ins[-1])
    if packet in _WRITE_ONLY:
        return sum(map(_nbytes, ins[1:])) + sum(map(_nbytes, outs))
    return sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))


def axis_bandwidth(mesh, axis: str) -> float:
    """B/s of one collective along ``axis`` of a row-major mesh of ranks,
    8 consecutive ranks a node: NVLink when the axis's groups lie within
    a node, else InfiniBand."""
    names = list(mesh.axis_names)
    stride = math.prod(mesh.shape[a] for a in names[names.index(axis) + 1:])
    span = stride * mesh.shape[axis]
    in_node = span <= GPUS_PER_NODE and GPUS_PER_NODE % span == 0
    return NVLINK_BW if in_node else IB_BW


@dataclasses.dataclass
class StepCost:
    """One rank's account of a traced step (the reference's ``HloCost``,
    per device)."""

    flops: float = 0.0
    bytes: float = 0.0
    coll_by_kind: dict = dataclasses.field(default_factory=dict)
    unresolved_loops: int = 0  # always 0: an eager trace unrolls loops
    bytes_by_op: dict = dataclasses.field(default_factory=dict)
    coll_by_shape: dict = dataclasses.field(default_factory=dict)
    flops_by_dtype: dict = dataclasses.field(default_factory=dict)
    coll_by_axis: dict = dataclasses.field(default_factory=dict)
    coll_by_site: dict = dataclasses.field(default_factory=dict)
    axis_bw: dict = dataclasses.field(default_factory=dict)
    arg_bytes: int = 0  # the step's inputs (parameters, state, batch)
    peak_bytes: int = 0  # peak live bytes, the arguments included
    out_bytes: int = 0  # bytes the step's outputs hold beyond its inputs
    ops: int = 0
    off_meta: int = 0  # outputs not on ``meta`` (allocated for real)

    @property
    def coll_bytes(self) -> float:
        return float(sum(self.coll_by_kind.values()))

    @property
    def temp_bytes(self) -> int:
        return self.peak_bytes - self.arg_bytes

    def compute_seconds(self) -> float:
        if not self.flops_by_dtype:
            return self.flops / PEAK_FLOPS_BF16
        return sum(f / MATMUL_RATES.get(d, PEAK_FLOPS_FP32)
                   for d, f in self.flops_by_dtype.items())

    def collective_seconds(self) -> float:
        return sum(b / self.axis_bw.get(ax, IB_BW)
                   for ax, b in self.coll_by_axis.items())


class CostCounter(TorchDispatchMode):
    """Counts matmul FLOPs by dtype, bytes by op and live storage bytes
    of every aten op run under it (see the module doc).  Use through
    :func:`trace_cost`."""

    def __init__(self):
        super().__init__()
        self.cost = StepCost()
        self._live: dict = {}
        self._now = 0
        self._memo: dict = {}

    def track(self, t) -> None:
        """Count ``t``'s storage as live until it is freed."""
        if not isinstance(t, torch.Tensor):
            return
        s = t.untyped_storage()
        key = s._cdata
        if key in self._live:
            return
        n = s.nbytes()
        self._live[key] = n
        self._now += n
        self.cost.peak_bytes = max(self.cost.peak_bytes, self._now)
        weakref.finalize(s, self._free, key)

    def _free(self, key) -> None:
        self._now -= self._live.pop(key, 0)

    def _run(self, func, args, kwargs):
        """``func(*args, **kwargs)``, from the memo of meta results where
        it has this op's signature: a functional op that allocates its
        outputs gives outputs of the same shapes, strides and dtypes for
        the same inputs' metadata, so they are made with
        ``empty_strided`` instead of running the meta kernel again (most
        of a trace's time, e.g. each tile of a blockwise attention)."""
        key = _memo_key(func, args, kwargs)
        if key is not None and key in self._memo:
            kind, metas = self._memo[key]
            outs = [torch.empty_strided(shape, stride, dtype=dt,
                                        device="meta")
                    for shape, stride, dt in metas]
            return outs[0] if kind is None else kind(outs)
        out = func(*args, **kwargs)
        if key is not None:
            multi = isinstance(out, (tuple, list))
            flat = out if multi else (out,)
            if all(isinstance(t, torch.Tensor) and t.device.type == "meta"
                   and t.storage_offset() == 0 for t in flat):
                self._memo[key] = (type(out) if multi else None, [
                    (tuple(t.shape), t.stride(), t.dtype) for t in flat])
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._run(func, args, kwargs)
        c = self.cost
        ins = _unique_tensors((args, kwargs))
        outs = _unique_tensors(out)
        if all(t.device.type == "cpu" and t.numel() <= 1
               for t in ins + outs):
            return out  # a host scalar (a constant): no device work
        c.ops += 1
        packet = func._overloadpacket
        if packet in flop_registry:  # FlopCounterMode's own formulas
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            dt = _DTYPE_NAMES.get(ins[0].dtype, str(ins[0].dtype))
            c.flops_by_dtype[dt] = c.flops_by_dtype.get(dt, 0) + n
        b = op_bytes(func, ins, outs)
        if b:
            c.bytes += b
            name = str(packet)
            c.bytes_by_op[name] = c.bytes_by_op.get(name, 0) + b
        for t in outs:
            if t.device.type != "meta":
                c.off_meta += 1
            self.track(t)
        return out


def trace_cost(fn, *args, mesh=None):
    """Run ``fn(*args)`` under :class:`CostCounter`.  ``args`` are the
    step's inputs (their bytes are ``arg_bytes``); ``mesh`` is the step's
    :class:`~repro_torch.launch.mesh.RecordingMesh`, whose collectives
    the account takes.  Returns ``(fn's result, StepCost)``."""
    counter = CostCounter()
    for t in _unique_tensors(args):
        counter.track(t)
    c = counter.cost
    c.arg_bytes = counter._now
    n_records = len(mesh.records) if mesh is not None else 0
    with counter:
        out = fn(*args)
    c.flops = float(sum(c.flops_by_dtype.values()))
    arg_keys = {t.untyped_storage()._cdata for t in _unique_tensors(args)}
    out_keys = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                for t in _unique_tensors(out)}
    c.out_bytes = sum(n for k, n in out_keys.items() if k not in arg_keys)
    new = zip(mesh.records[n_records:], mesh.sites[n_records:]) \
        if mesh else ()
    for (kind, axis, nb), site in new:
        c.coll_by_site[site] = c.coll_by_site.get(site, 0) + nb
        c.coll_by_kind[kind] = c.coll_by_kind.get(kind, 0) + nb
        key = f"{kind}:{nb}"
        c.coll_by_shape[key] = c.coll_by_shape.get(key, 0) + nb
        c.coll_by_axis[axis] = c.coll_by_axis.get(axis, 0) + nb
        c.axis_bw[axis] = axis_bandwidth(mesh, axis)
    return out, c


# Backwards-compatible collective summary --------------------------------


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: dict
    total_bytes: int
    unresolved_loops: int


def collective_bytes(cost: StepCost) -> CollectiveStats:
    return CollectiveStats(cost.coll_by_kind, int(cost.coll_bytes),
                           cost.unresolved_loops)


# ---------------------------------------------------------------------------
# Roofline
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Roofline:
    flops: float  # total matmul FLOPs (global, all ranks)
    hbm_bytes: float  # total bytes accessed (global)
    coll_bytes: float  # total collective bytes (global)
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    bound: str
    model_flops: float = 0.0

    @property
    def dominant_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_fraction(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    def row(self) -> dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes, "chips": self.chips,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "bound": self.bound,
            "model_flops": self.model_flops,
            "useful_fraction": self.useful_fraction,
        }


def roofline_from_cost(cost: StepCost, chips: int, *,
                       model_flops: float = 0.0) -> Roofline:
    """Per-rank StepCost -> global three-term roofline (every rank runs
    the same step)."""
    compute_s = cost.compute_seconds()
    memory_s = cost.bytes / HBM_BW
    collective_s = cost.collective_seconds()
    bound = max((("compute", compute_s), ("memory", memory_s),
                 ("collective", collective_s)), key=lambda kv: kv[1])[0]
    return Roofline(cost.flops * chips, cost.bytes * chips,
                    cost.coll_bytes * chips, chips, compute_s, memory_s,
                    collective_s, bound, model_flops)


def model_flops_estimate(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N·D train (N = active params), 2·N·tokens inference,
    PLUS the causal-attention score/value FLOPs (2·2·b·s²·h·hd·½ forward):
    at 32k context the attention term dominates the weight term."""
    n_active = active_param_count(cfg)
    tokens = shape.global_batch * shape.seq_len
    b, s = shape.global_batch, shape.seq_len
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    attn_fwd = 2.0 * 2.0 * b * s * s * h * hd * 0.5  # QK^T + PV, causal
    if cfg.family == "ssm":
        attn_fwd = 0.0
    elif cfg.family == "hybrid":
        # only the shared block invocations attend
        attn_fwd *= lm.n_shared_invocations(cfg)
    else:
        attn_fwd *= cfg.n_layers
    if shape.kind == "train":
        return 6.0 * n_active * tokens + 3.0 * attn_fwd
    if shape.kind == "prefill":
        return 2.0 * n_active * tokens + attn_fwd
    # decode: 1 new token attends to the full cache
    attn_dec = 2.0 * 2.0 * b * s * h * hd
    if cfg.family == "ssm":
        attn_dec = 0.0
    elif cfg.family == "hybrid":
        attn_dec *= lm.n_shared_invocations(cfg)
    else:
        attn_dec *= cfg.n_layers
    return 2.0 * n_active * shape.global_batch + attn_dec


def _spec_leaves_with_paths(cfg):
    specs = lm.lm_param_specs(cfg)
    return [(list(path), s) for path, s in _leaves(specs)
            if isinstance(s, ParamSpec)]


def param_count(cfg) -> int:
    return sum(math.prod(s.shape) for _, s in _spec_leaves_with_paths(cfg))


def active_param_count(cfg) -> int:
    """Active params per token (MoE: top_k of the expert stack + the rest)."""
    total = param_count(cfg)
    if cfg.family != "moe" or cfg.n_experts == 0:
        return total
    expert = sum(
        math.prod(s.shape) for keys, s in _spec_leaves_with_paths(cfg)
        if "ffn" in keys and ("wi" in keys or "wo" in keys))
    active_expert = expert * cfg.top_k / cfg.n_experts
    return int(total - expert + active_expert)
