"""Decode serving loops (port of ``DecodeServer`` and
``ContinuousDecodeServer`` in ``src/repro/runtime/server.py``): greedy
decoding with the serving metrics of the paper's Table VII (output tok/s,
TTFT, ITL).

``DecodeServer`` decodes a fixed batch against dense KV caches.
``ContinuousDecodeServer`` overrides its two engine hooks (``_init_state``,
``_step_factory``) to decode over per-layer page pools, and adds
``serve_requests``: continuous batching, where requests join and leave
between steps.

The EP ranks of the MoE layers are hosted in this process by a
``LocalComm(ep_size)``; with ``ep_size=1`` the MoE layers take the dense
reference path, as the JAX server does off-mesh. ``DecodeServer(...,
comm=DistComm(...))`` is one process of a mesh launched one process per
rank (``launch/serve.py``): ``batch`` stays the global batch, as in the JAX
server, each process steps its own rows (``comm.batch_rows``), and
``serve`` gathers the token streams, so ``last_tokens`` is the global
stream in every process; the clocks are each process's own. The same holds
for ``ContinuousDecodeServer``: every process runs the one scheduler over
the global slots and observes the global tokens of each step, gathered over
the batch axes, so every process admits, pages and recycles alike, and
each steps its own rows of the step's inputs against page pools of the
global size. A step over a gloo ``DistComm`` is not captured
(``_compiled_step``). The clock stops after
``torch.cuda.synchronize()`` where the JAX server calls
``block_until_ready``.

Both servers step through a compiled step (``_compiled_step``): on the card
the step is captured once as a CUDA graph and replayed over the server's
own input buffers and state (``steps.CompiledStep``), where JAX jits it; on
the CPU it runs eagerly. ``pipeline_depth > 1`` keeps up to that many
fixed-batch steps in flight before the host blocks on the oldest; the next
token feeds device to device.

Telemetry (``runtime/telemetry.py``): ``tracer=`` and ``series=`` take a
``Tracer`` and a ``TimeSeries`` (None: the shared no-op singletons). The
spans wrap host code at step boundaries the servers already have:
``prefill`` around the token-by-token prefill and its synchronisation,
``serve_step`` around each step and the read-back that ends it (the
synchronisation of a fixed-batch step; a continuous step's token gather
over a ``DistComm`` and its copy to the host), ``admission`` around the
scheduler's ``advance``; the scheduler adds its ``admit`` and ``complete``
instants, and the continuous server one series row a step. They add no
device sync, so a captured step stays one replay and the token streams
are bitwise the same with tracing on or off. Over a ``DistComm`` each
process keeps its own. EPLB, fault tolerance and preemption, and their
spans, are not ported yet (ROADMAP A10).
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from repro_torch.comm import LocalComm
from repro_torch.device import disable_tf32, resolve_device, synchronize
from repro_torch.models.config import ArchConfig
from repro_torch.models.kv_pages import PageAllocator, pages_for_tokens
from repro_torch.models.transformer import (check_supported, init_decode_state,
                                            init_paged_decode_state)
from repro_torch.runtime.scheduler import ContinuousScheduler
from repro_torch.runtime.steps import (CompiledStep, make_paged_serve_step,
                                      make_serve_step)
from repro_torch.runtime.telemetry import NULL_SERIES, NULL_TRACER, json_safe
from repro_torch.weights import init_params


@dataclasses.dataclass
class ServeMetrics:
    ttft_s: float
    itl_mean_s: float
    itl_p99_s: float
    output_tok_s: float
    total_tokens: int
    # continuous batching only: per-request distributions under admission
    ttft_p50_s: float | None = None
    ttft_p95_s: float | None = None
    ttft_p99_s: float | None = None
    itl_p50_s: float | None = None
    itl_p95_s: float | None = None
    requests_completed: int | None = None
    serve_steps: int | None = None
    # paged KV: the allocator's high-water mark against the dense B x S_max
    # reservation, both in pages
    pages_peak: int | None = None
    pages_dense_equiv: int | None = None
    per_request: list | None = None        # per-request ttft/itl records
    # telemetry (None when tracing is off): Tracer.summary(), per span name
    # its count and total seconds; the TimeSeries rows
    timeline: dict | None = None
    series: list | None = None

    def as_dict(self):
        # json_safe: the telemetry rows may carry numpy or torch scalars
        return json_safe(dataclasses.asdict(self))


class DecodeServer:
    def __init__(self, cfg: ArchConfig, batch: int, max_len: int, *,
                 ep_size: int = 1, params=None, seed: int = 0, device=None,
                 pipeline_depth: int = 1, comm=None, tracer=None, series=None):
        check_supported(cfg)
        self.device = resolve_device(device)
        self.tracer = NULL_TRACER if tracer is None else tracer
        self.series = NULL_SERIES if series is None else series
        disable_tf32()                    # the router matmul stays full f32
        self.cfg, self.batch = cfg, batch
        if comm is not None and ep_size != 1:
            raise ValueError("pass ep_size (hosted ranks) or comm, not both")
        self.comm = comm if comm is not None else (LocalComm(ep_size) if ep_size > 1
                                                   else None)
        if comm is None and ep_size > 1 and batch % ep_size:
            raise ValueError(f"batch {batch} must divide by ep_size {ep_size}")
        # the rows of the global batch this process steps
        self.rows = self.comm.batch_rows(batch) if self.comm is not None else slice(0, batch)
        local = self.rows.stop - self.rows.start
        # without given params, each process draws the full tree from the
        # seed and keeps its shard
        self.params = (init_params(cfg, seed, self.device, comm=self.comm)
                       if params is None else params)
        self.pipeline_depth = max(int(pipeline_depth), 1)
        self.state = self._init_state(local, max_len)
        # the step's token input, which a captured step reads in place
        self._tokens = torch.zeros((local, 1), dtype=torch.int32, device=self.device)
        # compiled serve steps, keyed by placement, bounded to {current,
        # previous}: see _compiled_step
        self._step_cache: collections.OrderedDict = collections.OrderedDict()
        self._serve_step = self._compiled_step()
        self.last_tokens: np.ndarray | None = None

    # ---- engine hooks (ContinuousDecodeServer overrides both) ----

    def _init_state(self, batch: int, max_len: int):
        """Zeroed decode state for this engine's layout (dense KV caches)."""
        return init_decode_state(self.cfg, batch, max_len, self.device)

    def _step_factory(self):
        """The uncompiled serve step for this engine's layout;
        ``_compiled_step`` compiles this one."""
        return make_serve_step(self.cfg, self.comm)

    def _compiled_step(self) -> CompiledStep:
        """The compiled serve step for the current placement, cached per
        placement and bounded to two entries (current and previous): each
        captured graph pins its private memory pool. The placement is always
        None until EPLB is ported (ROADMAP A10)."""
        key = self.cfg.moe.placement if self.cfg.moe else None
        if key in self._step_cache:
            self._step_cache.move_to_end(key)
        else:
            # a gloo DistComm stages its collectives through the host,
            # which a CUDA graph cannot hold: its steps run eagerly
            self._step_cache[key] = CompiledStep(
                self._step_factory(),
                capture=self.comm is None or self.comm.capturable)
            while len(self._step_cache) > 2:
                self._step_cache.popitem(last=False)
        return self._step_cache[key]

    def close(self) -> None:
        """Release the captured graphs and their memory pools; the next step
        captures again. Call when retiring a server in a longer-lived
        process."""
        self._step_cache.clear()
        self._serve_step = self._compiled_step()

    def step(self, tokens: torch.Tensor) -> torch.Tensor:
        """One greedy decode step over this process's rows: [b, 1] tokens
        in, [b, 1] next tokens out (b = batch on one process)."""
        self._tokens.copy_(tokens)
        tok, self.state = self._serve_step(self.params, self.state,
                                           {"tokens": self._tokens})
        return tok

    def prefill(self, prompts):
        """Token-by-token prefill through the decode step (as the JAX
        harness does) of this process's rows of the global prompts [B, P].
        Returns (first generated token [b, 1], seconds)."""
        prompts = torch.as_tensor(prompts, dtype=torch.int32, device=self.device)[self.rows]
        t0 = time.perf_counter()
        tok = None
        with self.tracer.span("prefill", tokens=int(prompts.shape[1])):
            for i in range(prompts.shape[1]):
                tok = self.step(prompts[:, i:i + 1])
            synchronize(self.device)
        return tok, time.perf_counter() - t0

    def decode(self, first_tok: torch.Tensor, steps: int):
        """``steps`` greedy steps of this process's rows. Returns (tokens [b,
        steps+1] numpy, the first token included, and the per-step
        latencies in seconds)."""
        if self.pipeline_depth > 1:
            return self._decode_pipelined(first_tok, steps)
        tok = first_tok
        outs, itls = [tok], []
        for _ in range(steps):
            t0 = time.perf_counter()
            with self.tracer.span("serve_step"):
                tok = self.step(tok)
                synchronize(self.device)
            itls.append(time.perf_counter() - t0)
            outs.append(tok)
        return torch.cat(outs, dim=1).cpu().numpy(), np.asarray(itls)

    def _decode_pipelined(self, first_tok: torch.Tensor, steps: int):
        """Keep up to ``pipeline_depth`` steps in flight, blocking only on
        the oldest step's event. ITL is completion to completion, steady
        state only: the fill interval (start to first completion, which
        amortizes ``depth`` launches) is left out, so ``len(itls) == steps -
        1`` (a single step's window gives the fill interval). ``serve``
        charges tok/s against its own wall clock, never ``itls.sum()``."""
        cuda = self.device.type == "cuda"
        pending: collections.deque = collections.deque()
        done, marks = [], []

        def retire_oldest():
            d, ev = pending.popleft()
            if ev is not None:
                ev.synchronize()
            marks.append(time.perf_counter())
            done.append(d)

        tok = first_tok
        t0 = time.perf_counter()
        for _ in range(steps):
            tok = self.step(tok)
            ev = torch.cuda.Event() if cuda else None
            if ev is not None:
                ev.record()
            pending.append((tok, ev))
            if len(pending) >= self.pipeline_depth:
                retire_oldest()
        while pending:
            retire_oldest()
        if len(marks) > 1:
            itls = np.diff(np.asarray(marks))
        else:
            itls = np.asarray([m - t0 for m in marks])
        return torch.cat([first_tok] + done, dim=1).cpu().numpy(), itls

    def serve(self, prompts, gen_steps: int) -> ServeMetrics:
        first, ttft = self.prefill(prompts)
        t0 = time.perf_counter()
        toks, itls = self.decode(first, gen_steps)
        # over the decode wall clock, not itls.sum(): the pipelined path's
        # itls leave the fill interval out
        decode_wall = time.perf_counter() - t0
        if self.comm is not None:         # every process's rows, in batch order
            toks = self.comm.gather_batch(torch.from_numpy(toks).to(self.device)).cpu().numpy()
        self.last_tokens = toks           # [B, gen_steps+1] generated stream
        total = toks.shape[0] * toks.shape[1]
        return ServeMetrics(
            ttft_s=ttft, itl_mean_s=float(itls.mean()),
            itl_p99_s=float(np.percentile(itls, 99)),
            output_tok_s=total / (ttft + decode_wall), total_tokens=total,
            timeline=self.tracer.summary() or None,
            series=list(self.series.rows) or None)


class ContinuousDecodeServer(DecodeServer):
    """Continuous-batching serving engine over the paged KV pool.

    ``batch`` is the fixed slot count. The page table, lengths and active
    mask are host-built per-step inputs of fixed shape, owned by the
    scheduler and copied to the device once per step; no length is ever
    read back from it. The argmax of each step is read back, because the
    next step feeds each request's previous token.

    Per-request token streams equal running each request alone through the
    same engine: rows are independent end to end given zero-drop MoE
    capacity. A capacity_factor would let co-residents compete for expert
    slots, so it is refused.

    Over a ``DistComm`` every process builds the scheduler over the global
    ``batch`` from the same requests, steps its own rows (``self.rows``)
    and gathers each step's tokens over the batch axes before the
    scheduler observes them (one small all-gather a step, outside the
    compiled step). The scheduler reads no clock, randomness or set order
    for a decision, so the processes' admissions agree. Each process's
    page pools are the reference's global shape: page ids stay global and
    a process's rows write only the pages the scheduler gave them.
    """

    def __init__(self, cfg: ArchConfig, batch: int, max_len: int, *,
                 page_size: int = 8, num_pages: int | None = None, **kwargs):
        a = cfg.attn
        if a is None or a.window is not None:
            raise NotImplementedError(
                "continuous batching requires non-windowed attention "
                "(sliding-window paged decode is not implemented)")
        if a.kv_chunk % page_size:
            raise ValueError(
                f"kv_chunk={a.kv_chunk} must be a multiple of "
                f"page_size={page_size}: chunked prefill attention and the "
                "paged decode kernel must agree on tiling")
        if cfg.moe and cfg.moe.capacity_factor is not None:
            raise ValueError(
                "continuous batching requires zero-drop MoE routing "
                "(capacity_factor=None): capacity competition couples "
                "co-resident requests and breaks solo parity")
        if int(kwargs.get("pipeline_depth", 1)) > 1:
            raise ValueError("continuous batching is depth-1: the next step "
                             "consumes this step's tokens host-side")
        self.page_size = int(page_size)
        # page-table width: enough pages for max_len, rounded up so the
        # configured split count divides it (the extra entries are pad)
        mp = pages_for_tokens(max_len, self.page_size)
        s = max(int(a.decode_kv_splits), 1)
        self.max_pages = -(-mp // s) * s
        # the default pool is the dense-equivalent reservation, which never
        # runs out; a smaller pool realizes the memory win
        self.num_pages = (int(num_pages) if num_pages is not None
                          else batch * self.max_pages)
        self.max_len = max_len
        self.reqsched: ContinuousScheduler | None = None
        super().__init__(cfg, batch, max_len, **kwargs)
        # the step's inputs for this process's rows: one int32 device
        # buffer, each input's view at a 16-byte aligned offset, filled from
        # one pinned host buffer
        b = self.rows.stop - self.rows.start
        shapes = dict(tokens=(b, 1), page_tbl=(b, self.max_pages),
                      kv_lens=(b,), active=(b,))
        offs, n = {}, 0
        for name, shape in shapes.items():
            offs[name] = n
            n += -(-int(np.prod(shape)) // 4) * 4
        self._feed_host = torch.zeros(n, dtype=torch.int32,
                                      pin_memory=self.device.type == "cuda")
        self._feed_dev = torch.zeros(n, dtype=torch.int32, device=self.device)
        self._feed_slices = {name: slice(offs[name], offs[name] + int(np.prod(shape)))
                             for name, shape in shapes.items()}
        self._feed = {name: self._feed_dev[sl].view(shapes[name])
                      for name, sl in self._feed_slices.items()}
        self._feed_copied: torch.cuda.Event | None = None

    def _init_state(self, batch: int, max_len: int):
        return init_paged_decode_state(self.cfg, self.num_pages, self.page_size,
                                       self.device)

    def _step_factory(self):
        return make_paged_serve_step(self.cfg, self.comm)

    def step(self, tokens: torch.Tensor) -> torch.Tensor:
        """The fixed-batch step (and with it ``prefill``, ``decode`` and
        ``serve``) has no page table; this engine steps through
        ``step_feed`` and ``serve_requests``."""
        raise NotImplementedError("the continuous engine steps through "
                                  "step_feed / serve_requests, not step")

    def step_feed(self, feed: dict) -> torch.Tensor:
        """One paged step on the scheduler's numpy inputs over the global
        batch: this process's rows of them, written into the pinned host
        buffer and copied to the step's input buffer in one transfer.
        Returns the next tokens [b, 1] of those rows on the device."""
        if self._feed_copied is not None:
            self._feed_copied.synchronize()    # the last copy has read the host buffer
        host = self._feed_host.numpy()
        for name, sl in self._feed_slices.items():
            host[sl] = np.asarray(feed[name])[self.rows].reshape(-1)
        self._feed_dev.copy_(self._feed_host, non_blocking=True)
        if self.device.type == "cuda":
            self._feed_copied = torch.cuda.Event()
            self._feed_copied.record()
        tok, self.state = self._serve_step(self.params, self.state, self._feed)
        return tok

    def serve_requests(self, requests, max_steps: int | None = None
                       ) -> ServeMetrics:
        """Run the continuous-batching loop until every request completes
        (or ``max_steps``)."""
        allocator = PageAllocator(self.num_pages, self.page_size)
        sched = ContinuousScheduler(requests, self.batch, self.max_pages,
                                    allocator,
                                    tracer=self.tracer if self.tracer.enabled else None)
        self.reqsched = sched
        record = self.series.enabled
        t0 = last = time.perf_counter()
        step_idx = 0
        while not sched.done:
            if max_steps is not None and step_idx >= max_steps:
                break
            with self.tracer.span("admission"):
                feed = sched.advance(step_idx)
            with self.tracer.span("serve_step"):
                tok = self.step_feed(feed)
                if self.comm is not None:
                    # every process observes the global tokens, so every
                    # scheduler makes the same decisions
                    tok = self.comm.gather_batch(tok)
                out = tok.cpu().numpy()              # waits for the step
            now = time.perf_counter()
            sched.observe(out, now)
            if record:
                # host state only: the engine's occupancy at this boundary
                self.series.record(
                    kind="step", step=step_idx, itl_s=now - last,
                    queue_depth=len(sched.queue), active=sched.live_count,
                    pages_live=allocator.live_count,
                    pages_peak=allocator.peak_live)
            last = now
            step_idx += 1
        wall = time.perf_counter() - t0
        recs = [sched.request_metrics(rid) for rid in sorted(sched.finished)]
        ttfts = np.asarray([r["ttft_s"] for r in recs]) if recs else np.asarray([0.0])
        itls = np.concatenate([np.asarray(r["itl_s"]) for r in recs
                               if r["itl_s"]] or [np.zeros(1)])
        total = int(sum(r["tokens"] for r in recs))
        return ServeMetrics(
            ttft_s=float(ttfts.mean()),
            itl_mean_s=float(itls.mean()),
            itl_p99_s=float(np.percentile(itls, 99)),
            output_tok_s=total / wall if wall > 0 else 0.0,
            total_tokens=total,
            ttft_p50_s=float(np.percentile(ttfts, 50)),
            ttft_p95_s=float(np.percentile(ttfts, 95)),
            ttft_p99_s=float(np.percentile(ttfts, 99)),
            itl_p50_s=float(np.percentile(itls, 50)),
            itl_p95_s=float(np.percentile(itls, 95)),
            requests_completed=len(recs),
            serve_steps=step_idx,
            pages_peak=allocator.peak_live,
            # un-rounded B x ceil(S_max / page): what a dense [B, S_max]
            # cache pins whatever the live occupancy
            pages_dense_equiv=self.batch * pages_for_tokens(self.max_len,
                                                            self.page_size),
            per_request=recs,
            timeline=self.tracer.summary() or None,
            series=list(self.series.rows) or None)
