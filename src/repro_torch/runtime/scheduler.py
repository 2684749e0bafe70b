"""Continuous-batching request scheduler: admission, slot recycling and
paged-KV bookkeeping, all at decode-step boundaries (port of
``src/repro/runtime/scheduler.py``; host-side numpy, no torch).

The device step keeps fixed shapes: ``max_concurrency`` slots, with
per-step host-built inputs (tokens, page_tbl, kv_lens, active). Requests
join and leave only between steps.

Prefill is token by token through the decode step: a newly admitted
request feeds its prompt one token per step, and the step that consumes
the last prompt token emits the first generated token (TTFT). Each
request's token stream equals running it alone through the same engine:
rows are independent end to end (paged attention masks with exact zeros,
zero-drop MoE routes per token), so neither co-residents nor idle slots
computing masked garbage can perturb it.

Admission is reservation-based: a request is admitted only if the page pool
can cover its worst-case footprint (prompt + max_new_tokens - 1 tokens) on
top of every live request's outstanding reservation. Pages are still
allocated lazily as tokens land, but a request, once admitted, can never
hit ``PagePoolExhausted`` and always runs to completion. With a
``tracer`` (``runtime/telemetry.py``) each admission and each completion
is an instant event, with the reference's args.

Every decision depends only on the step index, the arrivals, the allocator
and the tokens observed: no clock (it feeds only the per-request times), no
randomness, no iteration over a set. Processes that run one scheduler each
over the same requests and observe the same tokens therefore decide alike,
which the servers over a ``DistComm`` rely on; ``admissions`` logs each
decision as (step, rid, slot) so that they can be compared.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.models.kv_pages import PageAllocator, pages_for_tokens


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # [L] int32 prompt tokens
    max_new_tokens: int
    arrival_step: int = 0               # step at which it becomes visible

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size < 1:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.rid}: max_new_tokens must be >= 1")

    @property
    def total_tokens(self) -> int:
        """KV tokens written over the request's life: the prompt plus the
        fed-back generated tokens (the last one is never fed)."""
        return self.prompt.size + self.max_new_tokens - 1


@dataclasses.dataclass
class _Slot:
    req: Request
    pages: list                         # page ids owned, in table order
    fed: int = 0                        # tokens fed so far (== kv position)
    generated: list = dataclasses.field(default_factory=list)
    admit_t: float = 0.0
    first_tok_t: float | None = None
    tok_times: list = dataclasses.field(default_factory=list)


class ContinuousScheduler:
    """Host-side continuous-batching state machine.

    Per step: ``advance(step)`` admits arrivals, allocates boundary pages and
    returns the step's batch inputs; after the device step, ``observe(tok,
    now)`` records outputs, completes requests and frees their pages."""

    def __init__(self, requests, max_concurrency: int, max_pages: int,
                 allocator: PageAllocator, tracer=None):
        self.B = int(max_concurrency)
        self.max_pages = int(max_pages)
        self.alloc = allocator
        self.tracer = tracer
        page = allocator.page_size
        for r in requests:
            need = pages_for_tokens(r.total_tokens, page)
            if need > self.max_pages:
                raise ValueError(
                    f"request {r.rid}: needs {need} pages "
                    f"({r.total_tokens} tokens at page_size={page}) but the "
                    f"page table holds max_pages={self.max_pages}")
            if need > allocator.num_pages:
                raise ValueError(
                    f"request {r.rid}: needs {need} pages but the pool has "
                    f"only {allocator.num_pages}")
        self.queue: list[Request] = sorted(requests,
                                           key=lambda r: (r.arrival_step, r.rid))
        self.slots: list[_Slot | None] = [None] * self.B
        self.finished: dict[int, _Slot] = {}
        self.admissions: list[tuple[int, int, int]] = []   # (step, rid, slot)
        self._reserved = 0              # pages promised to live requests
        # persistent host-side batch inputs (rebuilt in place each step)
        self._tbl = np.full((self.B, self.max_pages), allocator.pad_page,
                            np.int32)
        self._lens = np.zeros((self.B,), np.int32)
        self._active = np.zeros((self.B,), np.int32)
        self._tokens = np.zeros((self.B, 1), np.int32)

    @property
    def done(self) -> bool:
        return not self.queue and all(s is None for s in self.slots)

    @property
    def live_count(self) -> int:
        return sum(s is not None for s in self.slots)

    def _outstanding(self, s: _Slot) -> int:
        """Pages this request may still allocate."""
        return (pages_for_tokens(s.req.total_tokens, self.alloc.page_size)
                - len(s.pages))

    def advance(self, step: int, now: float | None = None):
        """Admit arrivals into free slots (FIFO, reservation-gated), allocate
        page-boundary pages for every live request, and build this step's
        batch inputs: dict(tokens, page_tbl, kv_lens, active) of fixed-shape
        int32 numpy arrays."""
        now = time.perf_counter() if now is None else now
        # strictly FIFO: a too-big head-of-line request blocks later ones
        for i in range(self.B):
            if self.slots[i] is not None or not self.queue:
                continue
            r = self.queue[0]
            if r.arrival_step > step:
                break                    # arrivals are time-sorted
            need = pages_for_tokens(r.total_tokens, self.alloc.page_size)
            if self.alloc.free_count - self._reserved < need:
                break                    # the pool cannot guarantee completion yet
            self.queue.pop(0)
            self.slots[i] = _Slot(req=r, pages=[], admit_t=now)
            self.admissions.append((step, r.rid, i))
            self._reserved += need
            self._tbl[i, :] = self.alloc.pad_page
            self._lens[i] = 0
            if self.tracer is not None:
                self.tracer.instant("admit", rid=r.rid, step=step, slot=i,
                                    queued=len(self.queue))
        for i, s in enumerate(self.slots):
            if s is None:
                self._active[i] = 0
                self._tokens[i, 0] = 0
                continue
            pos = s.fed
            if pos % self.alloc.page_size == 0:
                # crossing into a fresh page: the reservation guarantees it
                (pid,) = self.alloc.alloc(1)
                s.pages.append(pid)
                self._reserved -= 1
                self._tbl[i, len(s.pages) - 1] = pid
            L = s.req.prompt.size
            self._tokens[i, 0] = (s.req.prompt[pos] if pos < L
                                  else s.generated[pos - L])
            self._lens[i] = pos
            self._active[i] = 1
        return dict(tokens=self._tokens.copy(),
                    page_tbl=self._tbl.copy(),
                    kv_lens=self._lens.copy(),
                    active=self._active.copy())

    def observe(self, out_tokens: np.ndarray, now: float | None = None):
        """Record the device step's outputs. Prompt-phase outputs are
        discarded until the step that consumed the last prompt token, whose
        output is the first generated token. Completed requests free their
        pages and their slot for the next ``advance``. Returns the ids of
        the requests completed at this boundary."""
        now = time.perf_counter() if now is None else now
        out = np.asarray(out_tokens).reshape(self.B, -1)[:, 0]
        completed = []
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            s.fed += 1
            if s.fed < s.req.prompt.size:
                continue                 # still consuming the prompt
            s.generated.append(int(out[i]))
            if s.first_tok_t is None:
                s.first_tok_t = now
            s.tok_times.append(now)
            if len(s.generated) >= s.req.max_new_tokens:
                self.alloc.free(s.pages)
                self._reserved -= self._outstanding(s)
                self.finished[s.req.rid] = s
                completed.append(s.req.rid)
                if self.tracer is not None:
                    self.tracer.instant("complete", rid=s.req.rid,
                                        tokens=len(s.generated))
                self.slots[i] = None
                self._tbl[i, :] = self.alloc.pad_page
                self._lens[i] = 0
                self._active[i] = 0
        return completed

    def tokens_for(self, rid: int) -> np.ndarray:
        return np.asarray(self.finished[rid].generated, np.int32)

    def request_metrics(self, rid: int) -> dict:
        s = self.finished[rid]
        itls = np.diff(np.asarray(s.tok_times)) if len(s.tok_times) > 1 else np.asarray([])
        return dict(rid=rid,
                    ttft_s=(s.first_tok_t - s.admit_t),
                    itl_s=itls.tolist(),
                    tokens=len(s.generated))
