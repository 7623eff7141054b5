"""Device meshes over ``torch.distributed`` ranks.

Port of ``repro.launch.mesh`` for the SPMD design of the port: one
process per rank, every rank holding the full parameters and running
the same program, and only each SC contraction split over named mesh
axes (``sc/sharded.py``).  A mesh lays the world's ranks out row-major
over its axes (``("data", "model")``, or ``("pod", "data", "model")``)
and gives, per axis, its size (``mesh.shape``, :func:`mesh_axis_sizes`),
this rank's coordinate (``mesh.coords``) and the process group of the
ranks that differ from this one on that axis alone (``mesh.group``).

:class:`AbstractMesh` is the sizes alone, with no process and no device,
as ``jax.sharding.AbstractMesh``: what the pure sharding functions
(``resolve_rules``, ``sharding/rules.py``) read, and
:func:`make_production_mesh` gives the reference's production sizes.
:class:`RecordingMesh` is an abstract mesh that stands as rank 0 and
records the collectives of a traced step instead of running them;
:func:`all_reduce` (SUM or MAX), :func:`all_gather` and
:func:`reduce_scatter` are the entry points every collective of the port
goes through.

The process group is made once per process by :func:`init_world`:
``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` / ``MASTER_PORT``) gives the world; without it the world
is this process alone, the reference's trivial mesh, where every axis
has size 1 and no collective runs.  Rank r runs on
``cuda:(LOCAL_RANK % device_count)`` unless the caller asks for the CPU.
The backend is NCCL when every rank of the host owns a card of its own,
gloo on the CPU and when ranks share a card (NCCL refuses two ranks on
one GPU); the choice is reported in ``mesh.backend``, never made
silently.  gloo runs every collective here on CUDA tensors (the
all-reduce, SUM and MAX, the all-gather and the reduce-scatter: torch
2.11's on the H100 machine, staging through the host inside
ProcessGroupGloo) as on the CPU's.

    torchrun --nproc-per-node 4 -m repro_torch.launch.serve --smoke \\
        --mesh --model-parallel 2 --device cpu
"""

from __future__ import annotations

import contextlib
import math
import os

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.obs.trace import current_tracer


class AbstractMesh:
    """Named axis sizes without ranks or devices (``jax``'s
    ``AbstractMesh``): ``shape`` maps each axis name to its size, in
    order."""

    def __init__(self, sizes, axis_names):
        sizes, axis_names = tuple(sizes), tuple(axis_names)
        if len(sizes) != len(axis_names):
            raise ValueError(f"sizes {sizes} vs axes {axis_names}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, sizes))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self):
        return f"{type(self).__name__}({self.shape})"


class DeviceMesh(AbstractMesh):
    """The world's ranks laid out row-major over named axes.

    ``rank`` / ``coords`` place this process; ``device`` is where it
    runs; ``group(axis)`` is the process group along ``axis`` (None in a
    world of one).  Every rank must build the same meshes in the same
    order: making a group is a collective over the world.
    """

    def __init__(self, sizes, axis_names, *, device=None):
        super().__init__(sizes, axis_names)
        world = init_world(device)
        self.rank, self.device, self.backend = (
            world["rank"], world["device"], world["backend"])
        if self.size != world["size"]:
            raise ValueError(
                f"mesh {self.shape} has {self.size} ranks, the world "
                f"{world['size']}")
        dims = tuple(self.shape.values())
        coords = [_unravel(r, dims) for r in range(self.size)]
        self.coords = dict(zip(self.axis_names, coords[self.rank]))
        self._groups = {}
        if self.size == 1:
            return
        for i, ax in enumerate(self.axis_names):
            lines: dict = {}  # ranks equal on every other axis
            for r, c in enumerate(coords):
                lines.setdefault(c[:i] + c[i + 1:], []).append(r)
            for ranks in lines.values():
                group = dist.new_group(ranks)
                if self.rank in ranks:
                    self._groups[ax] = group

    def group(self, axis: str):
        """The process group along ``axis`` (None in a world of one)."""
        return self._groups.get(axis)


class RecordingMesh(AbstractMesh):
    """An abstract mesh that stands as rank 0 (``coords`` all zero) and
    records the collectives run on it: each collective appends ``(kind,
    axis, operand bytes)`` to ``records`` (``kind`` "all-reduce",
    "all-gather" or "reduce-scatter") and its site to ``sites`` (an
    all-gather's span name, else the kind), and returns a tensor of the
    shape it would give, its values not the collective's.  What the
    dry-run (``launch/dryrun.py``) traces one rank of a production mesh
    on."""

    def __init__(self, sizes, axis_names):
        super().__init__(sizes, axis_names)
        self.coords = {ax: 0 for ax in self.axis_names}
        self.records = []
        self.sites = []

    def record(self, kind: str, axis: str, nbytes: int, site=None):
        self.records.append((kind, axis, nbytes))
        self.sites.append(site or kind)

    @classmethod
    def of(cls, mesh) -> "RecordingMesh":
        return cls(tuple(mesh.shape.values()), mesh.axis_names)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_reduce(t: torch.Tensor, mesh, axis: str, op: str = "sum"
               ) -> torch.Tensor:
    """Reduce ``t`` in place over the ranks of ``mesh`` along ``axis``
    (``op`` "sum" or "max").  On a :class:`RecordingMesh` it records
    ``("all-reduce", axis, bytes)`` and leaves ``t`` as it is."""
    if isinstance(mesh, RecordingMesh):
        mesh.record("all-reduce", axis, _nbytes(t))
        return t
    dist.all_reduce(t, op=_OPS[op], group=mesh.group(axis))
    return t


def all_gather(t: torch.Tensor, mesh, axis: str, dim: int = 0, *,
               span: str = "mesh.all_gather") -> torch.Tensor:
    """Every rank's ``t`` along ``axis``, concatenated on ``dim`` in
    coordinate order (bits copied exactly), timed as the tracer span
    ``span``.  Records ``("all-gather", axis, bytes of t)`` on a
    :class:`RecordingMesh`."""
    n = mesh.shape[axis]
    if isinstance(mesh, RecordingMesh):
        mesh.record("all-gather", axis, _nbytes(t), span)
        return torch.cat([t] * n, dim)
    with collective_span(span, t, axis=axis, bytes=_nbytes(t)):
        src = t.contiguous()
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=mesh.group(axis))
        return torch.cat(parts, dim)


def reduce_scatter(t: torch.Tensor, mesh, axis: str, dim: int = 0
                   ) -> torch.Tensor:
    """This rank's block, along ``dim``, of the SUM of ``t`` over the
    ranks of ``mesh`` along ``axis`` (``dim`` must split into the axis's
    size).  Records ``("reduce-scatter", axis, bytes of t)`` on a
    :class:`RecordingMesh`."""
    n = mesh.shape[axis]
    if t.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dimension {dim} of "
                         f"{tuple(t.shape)} does not split over {axis} ({n})")
    if isinstance(mesh, RecordingMesh):
        mesh.record("reduce-scatter", axis, _nbytes(t))
        return t.narrow(dim, 0, t.shape[dim] // n).clone()
    with collective_span("mesh.reduce_scatter", t, axis=axis,
                         bytes=_nbytes(t)):
        parts = [p.contiguous() for p in t.chunk(n, dim)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, group=mesh.group(axis))
        return out


def _unravel(rank: int, dims) -> tuple:
    """A rank's coordinates on a row-major mesh of ``dims``."""
    out = []
    for n in reversed(dims):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))


def init_world(device=None) -> dict:
    """This process's place in the world: ``rank``, ``size``,
    ``device`` and ``backend`` (None in a world of one).

    Joins the process group of ``torchrun``'s environment the first time
    (or reads the one already joined); without that environment the
    world is this process alone.  ``device`` None means this rank's
    card (``cuda:(LOCAL_RANK % device_count)``, raising without one),
    ``"cpu"`` the CPU.
    """
    device = resolve_device(device)
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend=_backend(device))
    if not dist.is_initialized():
        return dict(rank=0, size=1, device=device, backend=None)
    backend = dist.get_backend()
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the world joined over NCCL cannot run on the CPU")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return dict(rank=dist.get_rank(), size=dist.get_world_size(),
                device=device, backend=backend)


def _backend(device) -> str:
    """NCCL when every rank of this host owns a card, else gloo."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE",
                               os.environ.get("WORLD_SIZE", 1)))
    if device.type == "cuda" and local <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The reference's production mesh, sizes alone: ``(data 16, model
    16)`` = 256 ranks, or with a leading ``pod`` axis of 2 (512)."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def make_local_mesh(model_parallel: int = 1, *, device=None) -> DeviceMesh:
    """``(data = world / model_parallel, model = model_parallel)`` over
    the world's ranks (a world of one: the trivial 1 x 1 mesh)."""
    size = init_world(device)["size"]
    if model_parallel < 1 or size % model_parallel:
        raise ValueError(
            f"model_parallel={model_parallel} does not divide the world "
            f"of {size} ranks")
    return DeviceMesh((size // model_parallel, model_parallel),
                      ("data", "model"), device=device)


# The data-parallel axes: a batch's rows split over them, pod-major.
BATCH_AXES = ("pod", "data")


def mesh_axis_sizes(mesh) -> dict:
    return dict(mesh.shape)


def batch_axes(mesh) -> tuple:
    """The mesh's data-parallel axes of size > 1, in ``BATCH_AXES``
    order: the axes a training batch's rows are split over."""
    return tuple(a for a in BATCH_AXES if mesh.shape.get(a, 1) > 1)


def data_parallel_size(mesh) -> int:
    sizes = mesh_axis_sizes(mesh)
    return math.prod(sizes.get(a, 1) for a in BATCH_AXES)


@contextlib.contextmanager
def collective_span(name: str, t: torch.Tensor, **attrs):
    """A span of the installed tracer around a collective on ``t``.

    With no tracer (or a disabled one) this is a no-op.  With one, the
    device is synchronised first and last, so the span holds the
    collective alone and not the work queued before it."""
    tr = current_tracer()
    if tr is None or not tr.enabled:
        yield
        return
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    with tr.span(name, **attrs):
        yield
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
