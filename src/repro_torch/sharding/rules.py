"""Logical-axis -> mesh-axis sharding rules (FSDP x TP x EP x SP).

Port of ``repro.sharding.rules``.  The mesh is ``(data, model)``, with an
optional leading ``pod`` axis (pure data parallelism across pods).

Parameter rules are FSDP ∘ TP: a weight's parallelism axis (heads / mlp
/ experts / vocab) maps to ``model`` and its embed axis to ``data``;
indivisible dims replicate per tensor (``params.partition_specs``).
Activation rules are DP on batch (pod x data), TP on heads / mlp /
experts, and SP on the long-context cache sequence.

A spec here is a tuple with one entry per dimension (a mesh axis name, a
tuple of them, or None), what the reference's ``PartitionSpec`` holds.
:func:`param_shardings` gives each parameter leaf its :class:`Placement`:
where its shard lies on the mesh.  The mesh engine and the replicated
mesh train step hold every leaf whole on every rank and shard only each
SC contraction (:func:`sc_shard_rules`); the train step's FSDP ∘ TP
layout (``TrainConfig(fsdp=True)``, ``sharding/fsdp.py``) holds only the
rank's shard (:meth:`Placement.shard`) and all-gathers a leaf where it
is used (:meth:`Placement.gather`), and ``checkpoint.restore_resharded``
cuts each restored leaf to the rank's shard.  The sequence layouts
resolve here too: :func:`resid_seq_axes` (the residual stream's
sequence between a mesh step's layers) and :func:`cache_seq_axes` (the
decode cache's, ``launch/specs.py:cache_shardings``' axes), and
:func:`seq_block` gives a rank's :class:`SeqBlock` of either
(``sharding/seq.py`` moves the values).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.launch.mesh import all_gather
from repro_torch.models import params as params_lib

# Parameter logical axes.
PARAM_RULES = {
    "embed": "data",  # FSDP shard dimension
    "vocab": "model",
    "mlp": "model",
    "heads": "model",
    "kv_heads": "model",  # falls back to replicated when indivisible
    "head_dim": None,
    "kv_embed": "model",  # KV proj: TP moves to embed when kv_heads small
    "experts": "model",
    "expert_mlp": None,  # expert-internal FFN dim (EP owns model)
    "layers": None,  # stacked leading layer axis: never sharded
    "ssm_state": None,
    "ssm_inner": "model",
    "conv": None,
    None: None,
}

# Activation logical axes.
ACT_RULES = {
    "batch": ("pod", "data"),
    "seq": None,
    # Megatron-style sequence parallelism of the residual stream between
    # layers; indivisible lengths replicate per tensor.
    "resid_seq": "model",
    "cache_seq": "data",  # SP: long-context KV cache sharded over data
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    "vocab": "model",
    "ssm_inner": "model",
    "ssm_state": None,
    None: None,
}


def logical_rules(mesh, kind: str = "param") -> dict:
    """Rules dict + mesh axis sizes (so indivisible dims can replicate)."""
    base = dict(PARAM_RULES if kind == "param" else ACT_RULES)
    sizes = dict(mesh.shape)
    if "pod" not in sizes and kind == "act":
        # single-pod mesh: the batch rule must not name the pod axis
        base["batch"] = "data"
    base["__sizes__"] = sizes
    return base


def param_partition_specs(specs, mesh):
    return params_lib.partition_specs(specs, logical_rules(mesh, "param"))


@dataclasses.dataclass(frozen=True)
class Placement:
    """A leaf's place on a mesh (the reference's ``NamedSharding``): the
    mesh and one entry per dimension (a mesh axis, a tuple, or None).

    ``keep`` names mesh axes that :meth:`gather` does not gather over:
    along a dimension split over them the gathered leaf stays the rank's
    block (the expert leaves of the expert-parallel layout keep their
    ``model`` block and gather over ``data`` only; :meth:`keeping`)."""

    mesh: object
    spec: tuple
    keep: tuple = ()

    def keeping(self, axes) -> "Placement":
        """This placement with :meth:`gather` keeping the rank's block
        along ``axes`` as well."""
        return dataclasses.replace(
            self, keep=tuple(dict.fromkeys(self.keep + tuple(axes))))

    @property
    def device(self):
        """The device this rank holds the leaf on (None for a mesh of
        sizes alone)."""
        return getattr(self.mesh, "device", None)

    def dim_axes(self, ndim: int) -> list:
        """The mesh axes each of ``ndim`` dimensions is split over
        (major first; ``()`` where it is whole)."""
        out = []
        for i in range(ndim):
            entry = self.spec[i] if i < len(self.spec) else None
            out.append(() if entry is None else (
                entry if isinstance(entry, tuple) else (entry,)))
        return out

    def live_axes(self, ndim: int) -> tuple:
        """The mesh axes of size > 1 some dimension is split over: the
        ranks along them hold distinct shards."""
        sizes = dict(self.mesh.shape)
        return tuple(a for axes in self.dim_axes(ndim) for a in axes
                     if sizes[a] > 1)

    def shard_shape(self, global_shape) -> tuple:
        """One shard's shape, as ``NamedSharding.shard_shape`` gives it:
        each dimension over the span of its mesh axes."""
        sizes = dict(self.mesh.shape)
        out = []
        for i, (dim, axes) in enumerate(zip(
                global_shape, self.dim_axes(len(global_shape)))):
            span = math.prod(sizes[a] for a in axes)
            if dim % span:
                raise ValueError(
                    f"dimension {i} of {tuple(global_shape)} does not split "
                    f"over {axes} ({span})")
            out.append(dim // span)
        return tuple(out)

    def shard(self, t):
        """This rank's shard of the whole leaf ``t``: along each
        dimension the block at its row-major coordinate over the
        dimension's axes (``mesh.coords``, from ``launch/mesh.py``'s
        ``_unravel``), copied so the whole leaf can be freed.  A leaf no
        live axis splits is returned as it is."""
        if not self.live_axes(t.dim()):
            return t
        sizes, coords = dict(self.mesh.shape), self.mesh.coords
        shape = self.shard_shape(t.shape)
        for i, axes in enumerate(self.dim_axes(t.dim())):
            block = 0
            for a in axes:
                block = block * sizes[a] + coords[a]
            t = t.narrow(i, block * shape[i], shape[i])
        return t.clone(memory_format=torch.contiguous_format)

    def gather(self, shard):
        """The whole leaf from every rank's ``shard``: an all-gather
        over each live axis but the ``keep`` axes, dimension by
        dimension, the minor axis of a dimension first (bits copied
        exactly).  No autograd: the train step gathers through
        ``sharding.fsdp.GatherParam``."""
        sizes = dict(self.mesh.shape)
        for i, axes in enumerate(self.dim_axes(shard.dim())):
            for a in reversed(axes):
                if sizes[a] > 1 and a not in self.keep:
                    shard = all_gather(shard, self.mesh, a, i)
        return shard


def param_shardings(specs, mesh):
    """A :class:`Placement` per leaf of ``specs``, from
    :func:`param_partition_specs`."""
    rules = logical_rules(mesh, "param")
    return params_lib.tree_map_specs(
        lambda s: Placement(mesh, params_lib.partition_specs(s, rules)),
        specs)


def sc_shard_rules(mesh, *, batch=None, contract=None):
    """SC-substrate sharding rules adapted to ``mesh``: rows over the DP
    axes (``("pod", "data")``), the contraction over the TP axis
    (``"model"``) with a SUM merge.  Axes absent from the mesh are
    dropped here; size-1 and indivisible axes degrade per call inside
    ``sc_dot_sharded``."""
    from repro_torch.sc.sharded import DEFAULT_RULES, ScShardRules

    sizes = dict(mesh.shape)
    batch = tuple(batch if batch is not None else DEFAULT_RULES.batch)
    contract = tuple(
        contract if contract is not None else DEFAULT_RULES.contract
    )
    return ScShardRules(
        batch=tuple(a for a in batch if a in sizes),
        contract=tuple(a for a in contract if a in sizes),
    )


def act_spec(mesh, *axes) -> tuple:
    """An activation's spec from logical axis names."""
    rules = logical_rules(mesh, "act")
    sizes = rules["__sizes__"]
    entries = []
    for ax in axes:
        mesh_ax = rules.get(ax)
        if isinstance(mesh_ax, tuple):
            mesh_ax = tuple(a for a in mesh_ax if a in sizes) or None
            if mesh_ax is not None and len(mesh_ax) == 1:
                mesh_ax = mesh_ax[0]  # as PartitionSpec normalizes it
        elif mesh_ax is not None and mesh_ax not in sizes:
            mesh_ax = None
        entries.append(mesh_ax)
    return tuple(entries)


# ---------------------------------------------------------------------------
# Sequence layouts: the residual stream's (training) and the KV cache's
# ---------------------------------------------------------------------------


def spec_axes(entry) -> tuple:
    """The mesh axes of one spec entry (an axis, a tuple, or None)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def resid_seq_axes(mesh, length: int) -> tuple:
    """The mesh axes the residual stream's sequence of ``length``
    positions splits over between layers: ``act_spec``'s ``"resid_seq"``
    (``model``), or none where the length does not divide the axes'
    span (the reference's ``make_constrain`` divisibility fallback)."""
    axes = spec_axes(act_spec(mesh, "resid_seq")[0])
    span = math.prod(mesh.shape[a] for a in axes)
    return axes if axes and length % span == 0 else ()


def cache_seq_axes(mesh, batch: int, max_len: int) -> tuple:
    """The mesh axes a decode cache's sequence of ``max_len`` positions
    splits over for a global ``batch``, exactly as
    ``launch/specs.py:cache_shardings`` lays it out: ``model``; first
    ``pod`` and ``data`` too where the batch leaves them unused (a batch
    of 1); none where ``max_len`` does not divide the axes' span."""
    sizes = dict(mesh.shape)
    axes = tuple(a for a in ("pod", "data") if a in sizes)
    rows = math.prod(sizes[a] for a in axes)
    used = bool(axes) and batch > 0 and (
        batch % rows == 0 or ("data" in sizes and batch % sizes["data"] == 0))
    seq = [] if used else list(axes)
    if "model" in sizes:
        seq.append("model")
    span = math.prod(sizes[a] for a in seq)
    return tuple(seq) if seq and max_len % span == 0 else ()


@dataclasses.dataclass(frozen=True)
class SeqBlock:
    """This rank's block of a sequence of ``length`` positions split
    over the mesh ``axes`` (major first): positions ``[start, stop)``,
    ``start = c·length/span`` for the rank's row-major coordinate ``c``
    over the axes.  :meth:`gather` and :meth:`slice` move a tensor
    between the block and the whole sequence through
    ``sharding/seq.py``'s autograd functions."""

    mesh: object
    axes: tuple
    length: int

    @property
    def span(self) -> int:
        return math.prod(self.mesh.shape[a] for a in self.axes)

    @property
    def size(self) -> int:
        return self.length // self.span

    @property
    def index(self) -> int:
        c = 0
        for a in self.axes:
            c = c * self.mesh.shape[a] + self.mesh.coords[a]
        return c

    @property
    def start(self) -> int:
        return self.index * self.size

    @property
    def stop(self) -> int:
        return self.start + self.size

    def gather(self, x, dim: int = 1):
        """The whole sequence from every rank's block of ``x``."""
        from repro_torch.sharding.seq import SeqGather

        return SeqGather.apply(x, self, dim)

    def slice(self, x, dim: int = 1):
        """This rank's block of the whole sequence ``x``."""
        from repro_torch.sharding.seq import SeqSlice

        return SeqSlice.apply(x, self, dim)


def seq_block(mesh, axes: tuple, length: int):
    """This rank's :class:`SeqBlock` of ``length`` positions over
    ``axes`` (those of size 1 dropped), or None where no axis splits
    it."""
    live = tuple(a for a in axes if mesh.shape[a] > 1)
    if not live:
        return None
    span = math.prod(mesh.shape[a] for a in live)
    if length % span:
        raise ValueError(f"a sequence of {length} does not split over "
                         f"{live} ({span})")
    return SeqBlock(mesh, live, length)


# ---------------------------------------------------------------------------
# In-layer layouts: a rank's block of a feature dimension over ``model``
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ColBlock:
    """This rank's block of a dimension of ``length`` split over the mesh
    ``axes``: the dimension is ``parts`` equal segments (SwiGLU's gate and
    up halves of ``mlp_wi``), each split over the axes, and the rank
    holds positions ``[p·seg + start, p·seg + stop)`` of every part
    ``p`` (``seg = length / parts``), concatenated: ``width`` of them.
    :meth:`slice` and :meth:`gather` move a tensor between the block and
    the whole dimension through ``sharding/tp.py``'s autograd functions
    (a ``SeqBlock``'s arithmetic, on any dimension)."""

    mesh: object
    axes: tuple
    length: int
    parts: int = 1

    @property
    def span(self) -> int:
        return math.prod(self.mesh.shape[a] for a in self.axes)

    @property
    def size(self) -> int:
        return self.length // (self.parts * self.span)

    @property
    def width(self) -> int:
        return self.parts * self.size

    @property
    def index(self) -> int:
        c = 0
        for a in self.axes:
            c = c * self.mesh.shape[a] + self.mesh.coords[a]
        return c

    @property
    def start(self) -> int:
        return self.index * self.size

    @property
    def stop(self) -> int:
        return self.start + self.size

    def slice(self, x, dim: int = -1):
        """This rank's block of the whole ``x`` along ``dim``; the
        backward gathers the gradient's blocks."""
        from repro_torch.sharding.tp import ColSlice

        return ColSlice.apply(x, self, dim)

    def gather(self, x, dim: int = -1):
        """The whole dimension from every rank's block ``x``; the
        backward keeps the gradient's block."""
        from repro_torch.sharding.tp import ColGather

        return ColGather.apply(x, self, dim)


def col_block(mesh, axes: tuple, length: int, parts: int = 1):
    """This rank's :class:`ColBlock` of ``length`` over ``axes`` (those
    of size 1 dropped), or None where no axis splits it or it does not
    divide into ``parts`` segments over their span (the dimension stays
    whole)."""
    live = tuple(a for a in axes if mesh.shape.get(a, 1) > 1)
    if not live:
        return None
    span = math.prod(mesh.shape[a] for a in live)
    if length <= 0 or length % (parts * span):
        return None
    return ColBlock(mesh, live, length, parts)
