"""Step factories (port of ``make_train_step``, ``make_serve_step`` and
``make_paged_serve_step`` in ``src/repro/runtime/steps.py``) and the
compiled step that the servers run their serve steps through.

``make_train_step``: micro-batched gradient accumulation and AdamW, an eager
Python loop where JAX scans (no CUDA graph yet). Over a ``DistComm`` (one EP
rank per process) each process differentiates its own rows' part of the
global loss (``comm.py``'s convention), so the gradient of a parameter it
holds whole is its share, summed over the batch axes (``reduce_grads``),
while its experts' gradients are whole already: their tokens come to it
from the whole EP group. The clip norm is global (``grad_sq``). What JAX's
GSPMD does for ``make_train_step(cfg, mesh)``.

Both steps share one signature, (params, state, batch) -> (next tokens
[B, 1] int32, state), so the servers treat the dense and the paged engine
alike. The factories return the uncompiled step; ``CompiledStep`` is the
port's rendering of ``jax.jit(step, donate_argnums=(1,))``: on the card it
captures the step once as a CUDA graph and replays it, on the CPU it runs
the step eagerly.
"""
from __future__ import annotations

import math
import time

import torch

from repro_torch.comm import DistComm
from repro_torch.models.config import ArchConfig
from repro_torch.models.registry import get_model
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.optim.adamw import sq_sum
from repro_torch.weights import _leaves, is_cut

# the gradient reduce's largest all-reduce: the replicated leaves' f32 sums
# go in buckets of at most this many bytes (a flat copy of the four-card
# DBRX-132B cell's would take 5.3 GB)
BUCKET_BYTES = 256 << 20


def _float_leaves(tree) -> list:
    """The floating tensors of a parameter tree, in sorted-key order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _float_leaves(tree[k])]
    return [tree] if tree.is_floating_point() else []


def _like(tree, fn):
    if isinstance(tree, dict):
        return {k: _like(v, fn) for k, v in tree.items()}
    return fn(tree)


def reduce_axes(path, cfg: ArchConfig, comm) -> tuple[str, ...]:
    """The mesh axes over which the gradient of leaf ``path`` sums over a
    ``DistComm``'s processes: the batch axes, less the EP axes for a leaf
    the process holds only its part of (``weights.is_cut``: its experts,
    whose tokens come to it from every EP rank)."""
    if is_cut(path, cfg, comm):
        return tuple(a for a in comm.batch_axes if a not in comm.axis_names)
    return comm.batch_axes


def reduce_buckets(sums, cfg: ArchConfig, comm, cap_bytes: int = BUCKET_BYTES) -> list:
    """The gradient reduce's plan: [(axes, pieces)], each piece a flat view
    of an f32 sum. The leaves in sorted-key order, each cut into pieces of
    at most ``cap_bytes``, the pieces of leaves with the same axes packed in
    order into buckets of at most ``cap_bytes``; leaves whose axes hold one
    process are left out. It depends on the shapes alone, so every process
    makes the same plan and runs its collectives in the same order."""
    sizes = dict(comm.mesh)
    cap = cap_bytes // 4
    done, open_ = [], {}
    for path, t in _leaves(sums):
        axes = reduce_axes(path, cfg, comm)
        if math.prod(sizes[a] for a in axes) == 1:
            continue
        flat = t.view(-1)
        for i in range(0, flat.numel(), cap):
            piece = flat[i:i + cap]
            cur = open_.setdefault(axes, [])
            if cur and sum(p.numel() for p in cur) + piece.numel() > cap:
                done.append((axes, cur))
                cur = open_[axes] = []
            cur.append(piece)
    return done + [(axes, cur) for axes, cur in open_.items() if cur]


@torch.no_grad()
def reduce_grads(sums, cfg: ArchConfig, comm) -> int:
    """Sum each process's f32 gradient sums over the processes that hold
    other rows, in place, bucket by bucket (``reduce_buckets``); returns
    the bytes reduced. A bucket of one piece is summed where it lies, more
    go through one packed buffer."""
    total = 0
    for axes, pieces in reduce_buckets(sums, cfg, comm):
        if len(pieces) == 1:
            comm.sum_(pieces[0], axes)
        else:
            buf = torch.cat(pieces)
            comm.sum_(buf, axes)
            for piece, part in zip(pieces, buf.split([p.numel() for p in pieces])):
                piece.copy_(part)
            del buf
        total += sum(p.numel() for p in pieces) * 4
    return total


@torch.no_grad()
def grad_sq(sums, cfg: ArchConfig, comm) -> torch.Tensor:
    """The global sum of the squares of the gradients ``sums``: over a
    ``DistComm`` the whole leaves' squares once, as every process holds the
    same (reduced) values, and the cut leaves' squares summed over the axes
    they are cut along (the EP axes and expert-TP's), so that every process
    gets the same value."""
    leaves = list(_leaves(sums))
    dev = leaves[0][1].device
    if not isinstance(comm, DistComm):
        return sq_sum([t for _, t in leaves], dev)
    cut = [is_cut(path, cfg, comm) for path, _ in leaves]
    gsq = sq_sum([t for (_, t), c in zip(leaves, cut) if not c], dev)
    if any(cut):
        axes = comm.axis_names + ((comm.tp_axis,) if comm.tp_axis else ())
        part = sq_sum([t for (_, t), c in zip(leaves, cut) if c], dev)
        gsq = gsq + comm.all_reduce([part], axis=axes)[0]
    return gsq


def make_grad_step(cfg: ArchConfig, comm):
    """(params, batch) -> (loss, sums): the train step up to its update.
    Batch leaves [g, B/g, S] (over a ``DistComm`` this process's rows of
    each micro-batch, ``comm.batch_rows``): for each of the g micro-batches
    the loss of ``get_model(cfg).forward`` and its gradients (in each
    parameter's dtype, as JAX's ``value_and_grad``), added to f32 sums; the
    sums divided by g and, over a ``DistComm``, reduced (``reduce_grads``).
    ``loss`` is the mean over the micro-batches. The forward runs on
    detached leaves that require grad and share the parameters' storage,
    so the caller's tensors keep their ``requires_grad``."""
    model = get_model(cfg)
    dist_comm = isinstance(comm, DistComm)

    def grad_step(params, batch):
        g = batch["tokens"].shape[0]
        tracked = _like(params, lambda t: t.detach().requires_grad_()
                        if t.is_floating_point() else t)
        leaves = _float_leaves(tracked)
        sums = _like(params, lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                                    device=t.device))
        flat_sums = _float_leaves(sums)
        loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for i in range(g):
            loss, _ = model.forward(tracked, {k: v[i] for k, v in batch.items()}, cfg, comm)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            with torch.no_grad():
                for acc, gr in zip(flat_sums, grads):
                    if gr is not None:
                        acc.add_(gr)
                loss_sum = loss_sum + loss.detach().float()
            del loss, grads
        del tracked, leaves
        with torch.no_grad():
            for acc in flat_sums:
                acc.div_(g)
        if dist_comm:
            reduce_grads(sums, cfg, comm)
        return loss_sum / g, sums

    return grad_step


def make_train_step(cfg: ArchConfig, comm, opt_cfg: AdamWConfig | None = None):
    """(params, opt_state, batch) -> (params, opt_state, metrics):
    ``make_grad_step``, then ``adamw_update`` with the global norm
    (``grad_sq``), which updates the parameters and the moments in place.
    Metrics: ``loss``, ``grad_norm``, ``lr``. What the step returns can be
    served as it is. Over no communicator, a ``LocalComm`` or a
    ``DistComm``."""
    opt_cfg = opt_cfg or AdamWConfig()
    grad_step = make_grad_step(cfg, comm)

    def train_step(params, opt_state, batch):
        loss, sums = grad_step(params, batch)
        params, opt_state, om = adamw_update(params, sums, opt_state, opt_cfg,
                                             gsq=grad_sq(sums, cfg, comm))
        return params, opt_state, dict(loss=loss, **om)

    return train_step


def _greedy(decode_step, cfg: ArchConfig, comm):
    def serve_step(params, state, batch):
        logits, state = decode_step(params, state, batch, cfg, comm)
        next_tok = logits[:, -1, :cfg.vocab].argmax(-1).to(torch.int32)
        return next_tok[:, None], state

    return serve_step


def make_serve_step(cfg: ArchConfig, comm):
    """Greedy step over the family's dense decode state. batch: {tokens
    [B, 1]}."""
    return _greedy(get_model(cfg).decode_step, cfg, comm)


def make_paged_serve_step(cfg: ArchConfig, comm):
    """Greedy step over the paged pools. batch: {tokens [B, 1], page_tbl
    [B, max_pages], kv_lens [B], active [B]}."""
    return _greedy(get_model(cfg).paged_decode_step, cfg, comm)


# one capture stream per card, shared by every capture: a stream's first
# cuBLAS call allocates a workspace for it that lives as long as the
# process, and B3 keeps split-tile counters per stream
_CAPTURE_STREAMS: dict[int, torch.cuda.Stream] = {}


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream on which work is warmed up and captured on ``device``."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    stream = _CAPTURE_STREAMS.get(index)
    if stream is None:
        stream = torch.cuda.Stream(index)
        _CAPTURE_STREAMS[index] = stream
    return stream


class CompiledStep:
    """A serve step captured as a CUDA graph on the card.

    The first call on a CUDA batch runs the uncompiled step once on the
    card's capture stream (the warm-up: the kernels' one-time set-up,
    cuBLAS's workspace for that stream, B3's split-tile counters) and
    returns its result: it is a real step. It then captures the step on the
    same stream into a graph over the tensors of that call: the batch's
    tensors become the graph's static inputs and the state, which the step
    writes in place, its state (JAX donates the state instead). Every later
    call copies its batch into the static inputs (nothing when it passes
    those very tensors), replays the graph and returns a copy of the next
    tokens, made in stream order, so the next replay cannot overwrite what
    was returned.
    A call must pass the params and the state the graph was captured with;
    a capture or replay that fails raises, and nothing falls back to eager.

    On the CPU every call runs the uncompiled step, and so does every call
    with ``capture=False`` (a step whose collectives a graph cannot hold:
    gloo stages them through the host). A step over NCCL is captured: its
    warm-up runs every collective eagerly first, which creates NCCL's
    communicators before the capture, and ``ProcessGroupNCCL`` joins its
    own stream to the capture stream with events, which the graph records.
    """

    def __init__(self, fn, capture: bool = True):
        self.fn = fn
        self.capture = capture
        self.graph: torch.cuda.CUDAGraph | None = None
        self.capture_s: float | None = None   # wall time of the capture
        self._static = None                   # (params, state, batch, tokens out)

    def __call__(self, params, state, batch):
        if batch["tokens"].device.type != "cuda" or not self.capture:
            return self.fn(params, state, batch)
        if self.graph is None:
            return self._warm_up_and_capture(params, state, batch)
        s_params, s_state, s_batch, out = self._static
        if params is not s_params or state is not s_state or batch.keys() != s_batch.keys():
            raise ValueError("a captured step replays over the params, state and "
                             "batch keys it was captured with")
        for k, v in batch.items():
            if v is not s_batch[k]:
                s_batch[k].copy_(v)
        self.graph.replay()
        return out.clone(), state

    def _warm_up_and_capture(self, params, state, batch):
        cur = torch.cuda.current_stream()
        side = capture_stream(cur.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            tok, st = self.fn(params, state, batch)
        if st is not state:
            raise ValueError("the step returned a new state: a captured step must "
                             "write its state in place")
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out, _ = self.fn(params, state, batch)
        self.capture_s = time.perf_counter() - t0
        self.graph, self._static = graph, (params, state, dict(batch), out)
        cur.wait_stream(side)
        tok.record_stream(cur)       # made on the side stream, used on this one
        return tok, state
