"""The tensor-parallel context and the training mesh (port of
``repro.distributed.ctx``).

The reference activates a ``(mesh, rules)`` pair while it traces a step,
and GSPMD partitions the program.  PyTorch has no GSPMD, so the port is
explicit SPMD: one process per rank, each holding its own tile of every
sharded weight and of the KV pool, all running the same code on the same
inputs and meeting at the collectives.  Its counterpart of the pair is a
``TP`` object: the process group, this rank, the group's size and the
device; the rules table stays with the engine.  The engine enters it
around its forwards (``maybe_use``); ``layers.qeinsum`` and the decoder
read it (``current``, ``tp_size``) to pick the K4 GEMM and to place the
collectives.

Training runs on a data x model ``Mesh``: each rank belongs to one model
group (its row: the ranks that split the weights' tensor-parallel dims)
and one data group (its column: the ranks that split the batch and, under
FSDP, the weights' ``embed`` dims).  ``use_mesh`` enters it around a
step: ``current()`` is then the model group where the rules cut weights
over it (what the serving call sites read), and ``data()`` the data group,
over which ``core.qconfig.q_act`` max-reduces an activation's tensor amax
and ``core.losses`` sums a masked mean's count.  A weight tile's amax is
the step's table's (``tile_amax``); a view of a split tile that the
table does not hold raises rather than take its own amax.

``cst`` has no counterpart: no activation is resharded implicitly.  Every
change of layout is a collective the model code names (the row-parallel
GEMM's all-reduce, the vocab-parallel embedding's all-reduce, the logits'
all-gather).  Under grad each goes through an ``autograd.Function`` with
its conjugate backward (``copy_to_model``, ``reduce_from_model``,
``gather_from_model``, ``scatter_from_model``); an amax's max all-reduce
takes no gradient, as the straight-through QDQ gives its amax none.
Without grad they are the plain collectives, so serving computes what it
did.

The collectives run through ``torch.distributed``.  With the gloo
backend (this slice's, also on the card) a tensor on the card goes
through a host copy in every call: gloo moves host memory.  That follows
from the rank's device, never from a failure.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class TP:
    """One rank's view of a tensor-parallel group."""

    group: Any                  # a torch.distributed process group
    rank: int
    size: int
    device: torch.device
    # collectives since the last ``reset_counts`` and their host seconds
    # (host copies included; on the card from the moment the card's queued
    # work is done, so time the card spends computing is not counted)
    counts: dict = dataclasses.field(
        default_factory=lambda: {"calls": 0, "seconds": 0.0}, compare=False)

    @property
    def stage(self) -> bool:
        """gloo moves host memory: a tensor on the card goes through a
        host copy in every collective."""
        return self.device.type == "cuda"

    def reset_counts(self) -> None:
        self.counts.update(calls=0, seconds=0.0)

    def _count(self, t0: float) -> None:
        self.counts["calls"] += 1
        self.counts["seconds"] += time.perf_counter() - t0

    def _host(self, x: torch.Tensor) -> torch.Tensor:
        return x.cpu() if self.stage else x

    def _start(self) -> float:
        if self.stage:      # the host copy waits for the card anyway
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The sum (or max) of ``x`` over the group, in f32, then cast back
        to ``x``'s dtype; every rank gets the same bits."""
        t0 = self._start()
        buf = self._host(x.to(torch.float32)).contiguous()
        if buf.data_ptr() == x.data_ptr():
            buf = buf.clone()
        dist.all_reduce(buf, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=self.group)
        out = buf.to(device=x.device, dtype=x.dtype)
        self._count(t0)
        return out

    def all_gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order.
        The bytes move as they are (any dtype: gloo takes no float8, so
        every tensor travels as its bytes), each rank's part broadcast
        from it into its row of one host buffer (gloo's broadcast moves
        large tensors several times faster than its all-gather)."""
        t0 = self._start()
        x = x.contiguous()
        n = x.numel() * x.element_size()
        buf = torch.empty((self.size, n), dtype=torch.uint8)
        buf[self.rank].copy_(x.reshape(-1).view(torch.uint8))
        for r in range(self.size):
            dist.broadcast(buf[r], src=dist.get_global_rank(self.group, r)
                           if self.group is not dist.group.WORLD else r,
                           group=self.group)
        rows = buf.to(x.device)
        out = torch.cat([rows[r].view(x.dtype).reshape(x.shape)
                         for r in range(self.size)], dim)
        self._count(t0)
        return out

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's slice along ``dim`` of the sum over the group: each
        rank's slices exchanged as their bytes (``all_to_all``), then
        summed in f32 in rank order and cast back to ``x``'s dtype."""
        t0 = self._start()
        dim = dim % x.ndim
        parts = torch.stack(x.chunk(self.size, dim))
        src = self._host(parts).contiguous().view(torch.uint8).reshape(-1)
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self.group)
        got = out.view(x.dtype).reshape(parts.shape).to(x.device)
        acc = got[0].to(torch.float32)
        for i in range(1, self.size):
            acc += got[i].to(torch.float32)
        out = acc.to(x.dtype)
        self._count(t0)
        return out


_CTX: list = []


@contextlib.contextmanager
def use(tp: TP):
    _CTX.append(tp)
    try:
        yield
    finally:
        _CTX.pop()


def maybe_use(tp: TP | None):
    """``use(tp)``, or a no-op context when ``tp`` is None: the one way
    the engine enters the tensor-parallel context."""
    return use(tp) if tp is not None else contextlib.nullcontext()


def active() -> bool:
    return bool(_CTX)


def current() -> TP | None:
    """The innermost active context, or None."""
    return _CTX[-1] if _CTX else None


def tp_size() -> int:
    """The active group's size (1 without a context)."""
    return _CTX[-1].size if _CTX else 1


# ---------------------------------------------------------------------------
# collectives under autograd
# ---------------------------------------------------------------------------


def _tracked(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_reduce(g), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return tp.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim, ctx.n = tp, dim, x.shape[dim]
        return tp.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.tp.rank * ctx.n, ctx.n), None, None


class _ScatterFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return tp.reduce_scatter(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_gather(g, ctx.dim), None, None


def copy_to_model(x: torch.Tensor, tp: TP | None) -> torch.Tensor:
    """A column-parallel site's input: forward the identity, backward the
    sum over the model group of each rank's gradient (each rank's columns
    see only their own share of it)."""
    if tp is None or tp.size == 1 or not _tracked(x):
        return x
    return _CopyToModel.apply(x, tp)


def reduce_from_model(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """A row-parallel site's partial sums (and the vocab-parallel
    embedding's rows): forward the sum over the group, backward the
    identity (every rank's output gradient is the same)."""
    if _tracked(x):
        return _ReduceFromModel.apply(x, tp)
    return tp.all_reduce(x)


def gather_from_model(x: torch.Tensor, tp: TP, dim: int = -1) -> torch.Tensor:
    """The logits' vocabulary tiles: forward the all-gather along ``dim``,
    backward this rank's slice of the gradient (every rank computes the
    same loss on the whole vocabulary)."""
    if _tracked(x):
        return _GatherFromModel.apply(x, tp, dim % x.ndim)
    return tp.all_gather(x, dim)


def scatter_from_model(x: torch.Tensor, tp: TP, dim: int = -1) -> torch.Tensor:
    """A row-parallel site whose output each rank consumes only on its own
    slice (RG-LRU's gates: every rank's K-split partial pre-activations,
    the gates then taken on the rank's channels): forward the sum over the
    group of every rank's partial, this rank's slice along ``dim`` kept
    (``TP.reduce_scatter``); backward every rank's slice of the gradient
    all-gathered along ``dim`` (each partial feeds every rank's slice)."""
    if _tracked(x):
        return _ScatterFromModel.apply(x, tp, dim % x.ndim)
    return tp.reduce_scatter(x, dim)


# ---------------------------------------------------------------------------
# the training mesh
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a data x model training mesh: rank
    ``d * model + m`` has data coordinate d and model coordinate m (the
    order of ``jax.make_mesh``'s devices)."""

    shape: dict                 # {"data": D, "model": M}
    rank: int                   # in the world group
    data: TP                    # this rank's column: same m, every d
    model: TP                   # this rank's row: same d, every m
    world: TP
    device: torch.device

    @property
    def coords(self) -> dict:
        return {"data": self.data.rank, "model": self.model.rank}

    def groups(self) -> dict:
        return {"data": self.data, "model": self.model, "world": self.world}

    def reset_counts(self) -> None:
        for tp in self.groups().values():
            tp.reset_counts()

    def counts(self) -> dict:
        """Collectives and their host seconds by group since the last
        ``reset_counts``."""
        return {k: dict(tp.counts) for k, tp in self.groups().items()}


def local_mesh(device) -> Mesh:
    """The (1, 1) mesh of one process: no process group, no collective."""
    device = torch.device(device)
    one = lambda: TP(group=None, rank=0, size=1, device=device)
    return Mesh(shape={"data": 1, "model": 1}, rank=0, data=one(),
                model=one(), world=one(), device=device)


_MESH: list = []
# depth of ``data_replicated`` regions (a global MoE dispatch on a mesh)
_REPLICATED: list = []


def model_group(mesh: Mesh, rules) -> TP | None:
    """The mesh's model group where ``rules`` cut weights over a model
    axis of more than one rank (``fsdp_tp``, ``tp_only``), else None."""
    splits = any("model" in axes for name, axes in rules.table.items()
                 if name != "batch")
    return mesh.model if mesh.shape["model"] > 1 and splits else None


@contextlib.contextmanager
def use_mesh(mesh: Mesh, rules, tile_amax: dict | None = None):
    """Enter the training mesh around a step: ``current()`` is its
    ``model_group`` (None: the layers run as on one device, and under
    ``fsdp_only`` and ``dp_only`` a model row repeats the same work);
    ``data()`` is its data group.  ``tile_amax``: the step's weight tiles'
    tensor amaxes over the model group, by tile (``tile_key``), taken in
    one collective before the forward."""
    table = tile_amax or {}
    _MESH.append((mesh, table, {k[0] for k in table}))
    try:
        with maybe_use(model_group(mesh, rules)):
            yield
    finally:
        _MESH.pop()


def mesh() -> Mesh | None:
    """The training mesh entered by ``use_mesh``, or None."""
    return _MESH[-1][0] if _MESH else None


def data() -> TP | None:
    """The training mesh's data group, or None off a training mesh and
    inside ``data_replicated``."""
    return _MESH[-1][0].data if _MESH and not _REPLICATED else None


@contextlib.contextmanager
def data_replicated():
    """A stretch of a mesh step whose tensors are the same on every data
    rank (the MoE's global dispatch gathers the batch's tokens first):
    ``data()`` is None inside, so no amax is max-reduced and no probe is
    summed over the data group (which would count each element D times)."""
    _REPLICATED.append(True)
    try:
        yield
    finally:
        _REPLICATED.pop()


def tile_key(w: torch.Tensor) -> tuple:
    """A weight tile's key in ``use_mesh``'s amax table: its storage, its
    first element's address and its element count (a layer's slice of a
    stacked tile is a view; a transposed or reshaped view of a tile, the
    tied unembedding ``embed.T``, holds the same elements and the same
    key)."""
    return (w.untyped_storage().data_ptr(), w.data_ptr(), w.numel())


def tile_amax(w: torch.Tensor) -> torch.Tensor | None:
    """The model group's amax of weight tile ``w`` from the step's table;
    None off a training mesh and for a weight the table does not hold
    (one the rules keep whole over the model group: its own amax is the
    whole weight's).  A view of a split tile that is not the tile, or a
    layer's slice of it (a narrowed or offset piece), raises: its own
    amax would silently stand in for the whole weight's."""
    if not _MESH:
        return None
    _, table, storages = _MESH[-1]
    key = tile_key(w)
    got = table.get(key)
    if got is None and key[0] in storages:
        raise ValueError(
            f"a weight of shape {tuple(w.shape)} is a view of a tile split "
            "over the model group but not one the step's amax table holds "
            "(a narrowed or offset piece): its own amax is not the whole "
            "weight's")
    return got


def _over(tp: TP | None, x: torch.Tensor, op: str) -> torch.Tensor:
    if tp is None or tp.size == 1:
        return x
    return tp.all_reduce(x.detach(), op)


def data_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data group (x itself off a mesh or with one
    data rank); no gradient."""
    return _over(data(), x, "sum")


def data_max(x: torch.Tensor) -> torch.Tensor:
    """``x``'s maximum over the data group (an amax over the batch's
    rows); no gradient."""
    return _over(data(), x, "max")


def world_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over every rank of the mesh; no gradient."""
    m = mesh()
    return _over(m.world if m is not None else None, x, "sum")
