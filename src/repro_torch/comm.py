"""Communicators for the EP group.

The EP API takes one value per hosted rank, as a list indexed like
``comm.ranks``. A communicator offers what the EP paths need: the rank
count, the ranks this process hosts, the EP mesh's axes, a non-tiled
all-to-all over the whole group or over one axis of the mesh, an
all-gather and an all-reduce. The model layers and the servers also ask it
how the tokens lie over the mesh (``shard_tokens``, ``batch_rows``) and how
to put a per-process value back together (``unshard_tokens``,
``gather_batch``, ``sum_over_batch``).

``LocalComm(n)`` hosts all n ranks of the group in one process on one
device, the port's counterpart of the JAX package's fake devices under
``shard_map``: its all-to-all is a device-side transpose of the stacked send
buffers and its all-gather a stack. ``axes`` names the EP mesh's axes and
sizes, outermost first, as the JAX mesh does (``(("pod", 2), ("data", 4))``
is two pods of four); the rank is row-major over them, so the pod of a rank
is ``rank // inner_size`` (``src/repro/core/plan.py rank_pod``).

``DistComm(axes, ep_axes)`` is one rank per process over an initialised
``torch.distributed`` process group, whose backend carries the bytes (NCCL
for CUDA tensors, gloo for CPU ones). ``axes`` is the whole process mesh;
the EP axes are the ones the MoE layers exchange over, and a ``model`` axis
that is not one of them carries expert tensor parallelism, as
``src/repro/models/moe.py`` lays a JAX mesh out. Beside its groups a
``DistComm`` keeps a gloo group over the whole mesh for ``control_max``,
the servers' host-side agreement at each step boundary (a stop flag and
the dead ranks of elastic EP), which never waits on the card.

Under autograd a ``DistComm`` process differentiates its own copy of the
global loss, and each process's copy of a replicated value counts once
(JAX's gradients under ``shard_map``, where a replicated value is
invariant): the backward of an all-reduce whose result is used replicated
is the identity, of an all-gather the process's own block, of an
equal-block all-to-all the same exchange of the cotangents, of the slice of
a replicated tensor the all-gather of the slices' cotangents, and of a
replicated value entering a computation that differs along an axis
(``vary``, JAX's implicit ``pvary``) the sum of its cotangents over that
axis. Each is a ``torch.autograd.Function`` here, so no backward rests on
an in-place collective that autograd never saw. (The reduce of the
replicated parameters' gradients over the batch axes, the last such sum,
is the train step's: ``runtime/steps.py``.)
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

# torch 2.13 deprecates all_gather_into_tensor for all_gather_single, which
# older releases lack; both take (output, input, group)
_ALL_GATHER = (dist.all_gather_single if hasattr(dist, "all_gather_single")
               else dist.all_gather_into_tensor)


# the group of no axis: this process alone, no collective
_SELF = object()


def _check_axes(axes, n: int) -> tuple:
    axes = tuple((str(a), int(s)) for a, s in axes)
    if not axes or math.prod(s for _, s in axes) != n or min(s for _, s in axes) < 1:
        raise ValueError(f"mesh axes {axes} do not hold {n} ranks")
    if len({a for a, _ in axes}) != len(axes):
        raise ValueError(f"mesh axes {axes} repeat a name")
    return axes


def _coords(rank: int, sizes) -> tuple[int, ...]:
    """Row-major coordinates of ``rank`` on a mesh of ``sizes``."""
    out = []
    for s in reversed(sizes):
        out.append(rank % s)
        rank //= s
    return tuple(reversed(out))


def _row_major(coords, sizes) -> int:
    r = 0
    for c, s in zip(coords, sizes):
        r = r * s + c
    return r


def _bytes_view(t: torch.Tensor) -> torch.Tensor:
    """fp8 payloads move as their bytes: not every copy kernel or backend
    takes fp8."""
    if t.dtype.is_floating_point and t.dtype.itemsize == 1:
        return t.view(torch.uint8)
    return t


class LocalComm:
    """All ``n`` EP ranks hosted in this process (``ranks == range(n)``)
    on a mesh of ``axes`` ((name, size) pairs, outermost first; one axis
    ``"data"`` of n by default)."""

    # every axis is an EP axis: no expert tensor parallelism, and the tokens
    # split by batch rows only
    tp_axis = None
    seq_axis = None
    # its exchanges are device copies, which a CUDA graph captures
    capturable = True

    def __init__(self, n: int, axes=None):
        if n < 1:
            raise ValueError(f"LocalComm needs at least one rank, got {n}")
        self.axes = _check_axes((("data", n),) if axes is None else axes, n)
        self.size = n
        self.ranks = tuple(range(n))

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(a for a, _ in self.axes)

    @property
    def inner_size(self) -> int:
        """Size of the innermost axis: the ranks of one pod."""
        return self.axes[-1][1]

    @property
    def mesh(self) -> tuple:
        """The whole mesh: the EP axes, every rank hosted here."""
        return self.axes

    @property
    def token_axes(self) -> tuple[str, ...]:
        """The axes over which the ranks carry different tokens: all."""
        return self.axis_names

    def all_to_all(self, sends: list[torch.Tensor], axis: str | None = None) -> list[torch.Tensor]:
        """sends[src]: [N_axis, C, ...] -> recvs[dst]: [N_axis, C, ...], each
        contiguous — ``jax.lax.all_to_all(x, axis, split_axis=0,
        concat_axis=0, tiled=False)``. ``axis=None`` exchanges over the
        whole group (N_axis = n); a mesh axis name exchanges among the ranks
        that differ only in that coordinate, block j going to the rank
        whose coordinate is j. One device copy: the stacked buffers
        [s_0, ..., s_m, N_axis, C, ...] with the axis's dim and the block
        dim swapped. Differentiable: the swap is its own inverse, so the
        backward is the same exchange of the cotangents."""
        if len(sends) != self.size:
            raise ValueError(f"all_to_all got {len(sends)} buffers for "
                             f"{self.size} ranks")
        return list(_LocalAllToAll.apply(self, axis, *sends))

    def _exchange(self, sends: list[torch.Tensor], axis: str | None) -> list[torch.Tensor]:
        """The body of ``all_to_all``, outside autograd."""
        if axis is None:
            sizes, k = [self.size], 0
        elif axis in self.axis_names:
            sizes, k = [s for _, s in self.axes], self.axis_names.index(axis)
        else:
            raise ValueError(f"all_to_all over {axis!r}: the mesh axes are "
                             f"{self.axis_names}")
        dt = sends[0].dtype
        x = torch.stack([_bytes_view(s) for s in sends])
        if x.shape[1] != sizes[k]:
            raise ValueError(f"all_to_all over {axis or 'the group'} wants "
                             f"{sizes[k]} blocks per rank, got {x.shape[1]}")
        x = x.view(tuple(sizes) + tuple(x.shape[1:]))
        out = x.transpose(k, len(sizes)).contiguous().view(dt)
        return list(out.view((self.size,) + tuple(out.shape[len(sizes):])).unbind(0))

    def all_gather(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        """xs[r]: [T, ...] -> every rank gets [N, T, ...] in rank order."""
        if len(xs) != self.size:
            raise ValueError(f"all_gather got {len(xs)} tensors for "
                             f"{self.size} ranks")
        g = torch.stack(xs)
        return [g] * self.size

    def all_reduce(self, xs: list[torch.Tensor], axis=None) -> list[torch.Tensor]:
        """xs[r] -> for each rank, the sum of xs over the ranks that differ
        from it only in ``axis`` (a mesh axis name or a tuple of them;
        ``None``: the whole group) — ``jax.lax.psum(x, axis)``."""
        if len(xs) != self.size:
            raise ValueError(f"all_reduce got {len(xs)} tensors for "
                             f"{self.size} ranks")
        names = self.axis_names if axis is None else ((axis,) if isinstance(axis, str)
                                                      else tuple(axis))
        unknown = set(names) - set(self.axis_names)
        if unknown:
            raise ValueError(f"all_reduce over {sorted(unknown)}: the mesh axes "
                             f"are {self.axis_names}")
        sizes = [s for _, s in self.axes]
        x = torch.stack(xs).view(tuple(sizes) + tuple(xs[0].shape))
        dims = tuple(self.axis_names.index(a) for a in names)
        s = x.sum(dim=dims, keepdim=True, dtype=x.dtype).expand_as(x)
        return list(s.reshape((self.size,) + tuple(xs[0].shape)).unbind(0))

    # ---- the tokens' layout over the mesh ----

    def shard_tokens(self, x: torch.Tensor) -> list[torch.Tensor]:
        """The MoE layer's [B, S, D] tokens as each hosted rank's block:
        contiguous batch rows, rank order (every rank is hosted here)."""
        n = self.size
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} must split evenly over the "
                             f"{n} hosted ranks")
        return list(x.chunk(n))

    def unshard_tokens(self, parts: list[torch.Tensor]) -> torch.Tensor:
        return torch.cat(parts)

    def batch_rows(self, batch: int) -> slice:
        """The rows of a global batch this process steps: all of them."""
        return slice(0, batch)

    def gather_batch(self, t: torch.Tensor) -> torch.Tensor:
        """This process's rows of a batch-major tensor, globally: itself."""
        return t

    def sum_over_batch(self, t: torch.Tensor) -> torch.Tensor:
        """A per-process sum over its batch rows, summed over the processes
        that hold other rows: this process holds them all."""
        return t


class _LocalAllToAll(torch.autograd.Function):
    """``LocalComm.all_to_all`` as a Function: the exchange goes through a
    byte view, which has no ``grad_fn``, so autograd could not follow it."""

    @staticmethod
    def forward(ctx, comm, axis, *sends):
        ctx.comm, ctx.axis = comm, axis
        return tuple(comm._exchange(list(sends), axis))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + tuple(ctx.comm._exchange([g.contiguous() for g in grads],
                                                       ctx.axis))


class DistComm:
    """One EP rank in this process, over the initialised default process
    group (``init_process_group``; its backend carries every collective).

    ``axes`` is the process mesh as (name, size) pairs, outermost first,
    whose sizes multiply to the world size; this process sits at the
    row-major coordinates of its rank (``src/repro/core/plan.py my_rank``).
    ``ep_axes`` names the EP axes (default: every axis); the EP surface
    (``size``, ``ranks``, ``axes``, ``axis_names``, ``inner_size``) is
    ``LocalComm``'s over those axes alone, with ``ranks == (my EP rank,)``
    row-major over them, so every EP path takes a ``DistComm`` unchanged.
    As in ``src/repro/models/moe.py _token_specs``: the batch lies over
    ``("pod", "data")``; a ``model`` axis that is an EP axis splits the
    sequence inside the MoE layer; one that is not carries expert tensor
    parallelism (``tp_axis``), each process holding an F-slice of its
    experts. Every sub-group is made in ``__init__``, in the same order in
    every process, with ``timeout``.
    """

    def __init__(self, axes, ep_axes=None, *, timeout=None):
        if not dist.is_initialized():
            raise RuntimeError("DistComm needs an initialised default process group "
                               "(torch.distributed.init_process_group)")
        world = dist.get_world_size()
        self.mesh = _check_axes(axes, world)
        names = tuple(a for a, _ in self.mesh)
        sizes = tuple(s for _, s in self.mesh)
        ep = names if ep_axes is None else tuple(a for a in names if a in tuple(ep_axes))
        if not ep:
            raise ValueError(f"none of the EP axes {ep_axes} is on the mesh {self.mesh}")
        self.backend = dist.get_backend()
        # a gloo collective stages through the host, which a graph cannot hold
        self.capturable = self.backend == "nccl"
        self.coords = dict(zip(names, _coords(dist.get_rank(), sizes)))
        self.axes = tuple((a, s) for a, s in self.mesh if a in ep)
        self.size = math.prod(s for _, s in self.axes)
        self.ranks = (_row_major([self.coords[a] for a in ep],
                                 [s for _, s in self.axes]),)
        self.tp_axis = "model" if "model" in names and "model" not in ep else None
        # the axis that splits the sequence inside the MoE layer
        self.seq_axis = "model" if dict(self.axes).get("model", 1) > 1 else None
        self.rank = dist.get_rank()
        self.token_axes = tuple(a for a in names if a != self.tp_axis)
        self.batch_axes = tuple(a for a in names if a in ("pod", "data"))
        self._groups: dict[tuple, tuple] = {}
        for key in [(a,) for a in names] + [ep, self.token_axes, self.batch_axes]:
            if key and key not in self._groups:
                self._groups[key] = self._new_group(key, sizes, timeout)
        # the host-side twin of the whole mesh for control_max: a gloo group,
        # so that agreeing on a decision never queues behind steps in flight
        self._control = dist.new_group(backend="gloo", timeout=timeout)

    def _new_group(self, key: tuple, sizes, timeout):
        """(this process's group over the axes in ``key``, its size): one
        group per coordinate of the other axes, members in rank order, so
        the group rank is the row-major rank over ``key``. The whole mesh is
        the default group."""
        names = tuple(a for a, _ in self.mesh)
        n = math.prod(s for a, s in self.mesh if a in key)
        if n == math.prod(sizes):
            return None, n
        parts: dict[tuple, list[int]] = {}
        for r in range(math.prod(sizes)):
            c = _coords(r, sizes)
            parts.setdefault(tuple(x for a, x in zip(names, c) if a not in key), []).append(r)
        group, _ = dist.new_subgroups_by_enumeration(list(parts.values()), timeout=timeout)
        return group, n

    def _group(self, axis) -> tuple:
        """(group, size) over ``axis``: None for the EP axes, a mesh axis
        name, or a tuple of them (in mesh order)."""
        want = (tuple(a for a, _ in self.axes) if axis is None
                else (axis,) if isinstance(axis, str) else tuple(axis))
        key = tuple(a for a, _ in self.mesh if a in want)
        if len(key) != len(set(want)):
            raise ValueError(f"collective over {want!r}: the mesh axes are "
                             f"{tuple(a for a, _ in self.mesh)}")
        if not key:
            return _SELF, 1
        if len(key) == len(self.mesh):
            return None, math.prod(s for _, s in self.mesh)
        if key not in self._groups:
            raise ValueError(f"no sub-group over {key}: DistComm makes them over "
                             f"each axis, the EP, token and batch axes")
        return self._groups[key]

    def _group_rank(self, axis) -> int:
        """This process's rank in its group over ``axis`` (as ``_group``
        takes it): row-major over the group's axes, in mesh order."""
        want = (tuple(a for a, _ in self.axes) if axis is None
                else (axis,) if isinstance(axis, str) else tuple(axis))
        key = [(a, s) for a, s in self.mesh if a in want]
        return _row_major([self.coords[a] for a, _ in key], [s for _, s in key])

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(a for a, _ in self.axes)

    @property
    def inner_size(self) -> int:
        """Size of the innermost EP axis: the ranks of one pod."""
        return self.axes[-1][1]

    @staticmethod
    def _one(name: str, xs: list) -> torch.Tensor:
        if len(xs) != 1:
            raise ValueError(f"{name} got {len(xs)} tensors; a DistComm hosts one rank")
        return xs[0]

    def all_to_all(self, sends: list[torch.Tensor], axis: str | None = None) -> list[torch.Tensor]:
        """``LocalComm.all_to_all`` for the one hosted rank:
        ``all_to_all_single`` over the leading dim of sends[0] [N_axis, C,
        ...], on the EP axes' group (``axis=None``) or the named axis's."""
        x = self._one("all_to_all", sends)
        group, n = self._group(axis)
        if x.shape[0] != n:
            raise ValueError(f"all_to_all over {axis or 'the group'} wants {n} "
                             f"blocks per rank, got {x.shape[0]}")
        return [_DistAllToAll.apply(group, x)]

    def all_to_all_rows(self, x: torch.Tensor, send_counts: list[int],
                        recv_counts: list[int]) -> torch.Tensor:
        """Uneven exchange over the EP axes: rows [sum(send_counts), ...] of
        ``x``, send_counts[d] of them to EP rank d in order, -> the rows
        received, recv_counts[s] from EP rank s in order
        (``all_to_all_single`` with split sizes: the placement's weight
        migration)."""
        group, n = self._group(None)
        if len(send_counts) != n or len(recv_counts) != n:
            raise ValueError(f"all_to_all_rows over {n} ranks got {len(send_counts)} "
                             f"send and {len(recv_counts)} receive counts")
        src = _bytes_view(x).contiguous()
        out = src.new_empty((sum(recv_counts),) + tuple(x.shape[1:]))
        dist.all_to_all_single(out, src, output_split_sizes=list(recv_counts),
                               input_split_sizes=list(send_counts), group=group)
        return out.view(x.dtype)

    def control_max(self, values) -> list[int]:
        """The elementwise maximum of a few host integers over every process
        of the mesh (the EP group and, under expert-TP, its twins along
        ``model``): the servers' one decision a step boundary, each
        process's stop flag and dead-rank mask folded into one all-reduce.
        It runs on a gloo group beside the NCCL ones, on the host: over the
        NCCL stream its result would wait for the steps in flight and undo
        ``pipeline_depth > 1``."""
        t = torch.tensor([int(v) for v in values], dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._control)
        return t.tolist()

    def all_gather(self, xs: list[torch.Tensor], axis=None) -> list[torch.Tensor]:
        """xs[0]: [T, ...] -> [N, T, ...] in rank order over the EP axes
        (``axis=None``) or the named axes, gathered as the concatenation of
        [1, T, ...] blocks (gloo refuses an output of another rank than its
        input's)."""
        x = self._one("all_gather", xs)
        group, n = self._group(axis)
        if group is _SELF:
            return [x[None]]
        return [_DistAllGather.apply(group, n, self._group_rank(axis), x)]

    def all_reduce(self, xs: list[torch.Tensor], axis=None) -> list[torch.Tensor]:
        """The sum of xs[0] over the processes that differ from this one
        only in ``axis`` (a mesh axis name, a tuple of them, or None for
        the EP axes), in a new tensor. Its backward is the identity: the
        sum is used replicated over those processes, and each one's copy
        counts once."""
        x = self._one("all_reduce", xs)
        group, n = self._group(axis)
        if group is _SELF:
            return [x.clone()]
        return [_DistAllReduce.apply(group, x)]

    def sum_(self, t: torch.Tensor, axis) -> None:
        """Sum ``t`` in place over ``axis``, outside autograd: the train
        step's gradient reduce (``runtime/steps.py reduce_grads``)."""
        group, n = self._group(axis)
        if group is not _SELF:
            dist.all_reduce(t, group=group)

    def vary(self, xs: list[torch.Tensor], axis) -> list[torch.Tensor]:
        """A value replicated over ``axis`` (a mesh axis name or a tuple of
        them) as it enters a computation that differs along it: the value
        itself, whose backward sums the cotangents over ``axis``, since
        each process's part of the computation gives only its share of the
        replicated value's gradient (JAX: the ``pvary`` that ``shard_map``
        inserts, whose transpose is ``psum``). The expert FFN's input under
        expert-TP and the router under a sequence split enter so."""
        x = self._one("vary", xs)
        group, n = self._group(axis)
        if group is _SELF:
            return [x]
        return [_DistVary.apply(group, x)]

    # ---- the tokens' layout over the mesh ----

    def shard_tokens(self, x: torch.Tensor) -> list[torch.Tensor]:
        """The MoE layer's tokens of this rank: the process's own [B, S, D]
        rows, and of them the S-slice at its ``model`` coordinate when
        ``model`` is an EP axis (``_token_specs``: S splits over model).
        The slice's backward gathers the slices' cotangents over model: x
        is replicated there, and its gradient is theirs together."""
        if self.seq_axis is None:
            return [x]
        m = dict(self.axes)[self.seq_axis]
        if x.shape[1] % m:
            raise ValueError(f"sequence {x.shape[1]} must split evenly over "
                             f"model={m}")
        return [_SeqSlice.apply(self, x)]

    def unshard_tokens(self, parts: list[torch.Tensor]) -> torch.Tensor:
        y = self._one("unshard_tokens", parts)
        if self.seq_axis is None:
            return y
        return _join_seq(self.all_gather([y], axis=self.seq_axis)[0])

    def batch_rows(self, batch: int) -> slice:
        """The rows of a global batch this process steps: its block at the
        row-major coordinate over the batch axes."""
        names = self.batch_axes
        n = math.prod(s for a, s in self.mesh if a in names)
        if batch % n:
            raise ValueError(f"batch {batch} must split evenly over the "
                             f"{n} batch ranks ({names})")
        i = _row_major([self.coords[a] for a in names],
                       [s for a, s in self.mesh if a in names])
        b = batch // n
        return slice(i * b, (i + 1) * b)

    def gather_batch(self, t: torch.Tensor) -> torch.Tensor:
        """This process's rows [b, ...] of a batch-major tensor -> the
        global [B, ...], on every process."""
        g = self.all_gather([t], axis=self.batch_axes)[0]
        return g.reshape((-1,) + tuple(t.shape[1:]))

    def sum_over_batch(self, t: torch.Tensor) -> torch.Tensor:
        """A sum over this process's rows -> the sum over the whole batch."""
        return self.all_reduce([t], axis=self.batch_axes)[0]


def _join_seq(g: torch.Tensor) -> torch.Tensor:
    """[M, B, S/M, ...] S-slices in model order -> [B, S, ...]."""
    return g.transpose(0, 1).reshape(g.shape[1], -1, *g.shape[3:])


class _DistAllToAll(torch.autograd.Function):
    """``DistComm.all_to_all``'s exchange, ``all_to_all_single`` on a byte
    view; backward: the same exchange of the cotangents (block j of each
    went to the process at coordinate j, and comes back from it)."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return _a2a(group, x)

    @staticmethod
    def backward(ctx, g):
        return None, _a2a(ctx.group, g)


def _a2a(group, x: torch.Tensor) -> torch.Tensor:
    src = _bytes_view(x).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.view(x.dtype)


class _DistAllGather(torch.autograd.Function):
    """``DistComm.all_gather``: x [T, ...] -> [N, T, ...], gathered as the
    concatenation of [1, T, ...] blocks (gloo refuses an output of another
    rank than its input's); backward: this process's block of the
    cotangent, the gathered value being used replicated."""

    @staticmethod
    def forward(ctx, group, n, me, x):
        ctx.me = me
        src = _bytes_view(x).contiguous().reshape((1,) + tuple(x.shape))
        out = src.new_empty((n,) + tuple(x.shape))
        _ALL_GATHER(out, src, group=group)
        return out.view(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return None, None, None, g[ctx.me]


class _DistAllReduce(torch.autograd.Function):
    """``DistComm.all_reduce``'s sum in a new tensor; backward: the
    identity."""

    @staticmethod
    def forward(ctx, group, x):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return None, g


class _DistVary(torch.autograd.Function):
    """``DistComm.vary``: the identity; backward: the sum of the
    cotangents over the group."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        out = g.clone()
        dist.all_reduce(out, group=ctx.group)
        return None, out


class _SeqSlice(torch.autograd.Function):
    """``DistComm.shard_tokens``' S-slice of a replicated [B, S, ...];
    backward: the slices' cotangents gathered over the sequence axis."""

    @staticmethod
    def forward(ctx, comm, x):
        ctx.comm = comm
        m = dict(comm.axes)[comm.seq_axis]
        return x.chunk(m, dim=1)[comm.coords[comm.seq_axis]].contiguous()

    @staticmethod
    def backward(ctx, g):
        comm = ctx.comm
        return None, _join_seq(comm.all_gather([g.contiguous()], axis=comm.seq_axis)[0])
