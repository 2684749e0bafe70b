"""Decode serving loops (port of ``DecodeServer`` and
``ContinuousDecodeServer`` in ``src/repro/runtime/server.py``): greedy
decoding with the serving metrics of the paper's Table VII (output tok/s,
TTFT, ITL).

``DecodeServer`` decodes a fixed batch against the family's dense decode
state (``models/registry.py``: KV caches, and for ``gemma3`` ring caches in
its local layers). ``ContinuousDecodeServer`` overrides its two engine
hooks (``_init_state``, ``_step_factory``) to decode over per-layer page
pools, and adds ``serve_requests``: continuous batching, where requests
join and leave between steps. It refuses a family without a paged path
(``gemma3``), as the reference does.

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
process keeps its own.

EPLB (``rebalance_every``, ``num_redundant_experts``; the config must track
``expert_heat``): every ``rebalance_every`` steps, at a step boundary, the
hook drains the heat counter of the decode state (over a ``DistComm``,
summed over the token axes by one all-reduce), feeds it to a
``RebalanceScheduler`` (the same one, fed the same heat, in every process,
so all adopt the same table at the same step), and, when the table
changed, adopts the new placement: the device tables are built, the
physical expert weights rebound once (``params_physical``: in place on one
card, migrated between processes over a ``DistComm``), and the step is
captured anew under the new placement (the step cache keeps the current
and the previous one). The heat is read back only there, never inside a
step. Spans: ``rebalance`` (with ``adopt`` inside it), the
``placement_swap`` instant, ``drain`` on the pipelined path before a
swap; the ``rank_imbalance`` counter and a window row (``_record_window``).

Elastic EP (``fault_injector``, ``fault_detector``, ``miss_threshold``,
``ckpt_dir``; docs/DESIGN.md §9): a ``FaultDetector`` (fed by a
deterministic ``FaultInjector`` in tests and benches) is polled at every
decode-step boundary. On a detected rank death the server drains its steps
in flight and shrinks: the scheduler narrows to the survivors and emits a
degraded table (the dead rank's row all ``EMPTY``: zero slots, zero
traffic), the physical expert weights are re-adopted by collapsing through
the masked old table (surviving replicas only: in place on one card,
migrated between processes over a ``DistComm``, no bytes to the dead
card), the device tables are built and the step is captured anew. A rejoin
re-expands to a full-width table at the next boundary. The greedy stream
does not depend on the placement, so the tokens stay bitwise those of an
uninterrupted run. When an expert lost its last replica the recovery warns
``DegradedRecovery`` and restores the whole tree from ``ckpt_dir`` (rebound
to the degraded table) or raises ``RuntimeError``. ``PreemptionGuard``
(SIGTERM/SIGINT) is polled at the same boundaries: the server drains,
writes a placement-tagged checkpoint to ``ckpt_dir`` and returns with
``preempted=True``. ``ServeMetrics`` carries ``degraded_steps``,
``recovery_count``, ``recovery_latency_s``, ``recovery_events``,
``checkpoint_restores``, ``alive_ranks`` and ``preempted``. Spans:
``fault_poll``, the ``fault_detected`` instant, ``recover:shrink`` /
``recover:expand`` with ``recover:repack`` and ``recover:adopt`` inside,
``checkpoint`` (the save on preemption, a restore) and ``placement_swap``.
Only the recovery boundary reads the device (the heat), never a step. The
poll is host work and runs while the card computes the step (inside the
``serve_step`` span, before the read-back that ends it).

Over a ``DistComm`` the reference's one controller becomes one decision a
boundary: each process polls its own detector, then every process's stop
flag and dead-rank mask are folded into one small integer all-reduce
(MAX; ``DistComm.control_max``, on a host-side gloo group), so every
process recovers, or stops, at the same step from the same report, whether
a wall-clock ``timeout_s`` fired in one process only or a SIGTERM reached
one process first. A ``DistComm`` process holds only its own slots, so
``ckpt_dir`` over it is refused (ROADMAP A10d).
"""
from __future__ import annotations

import collections
import dataclasses
import time
import warnings

import numpy as np
import torch

from repro_torch.checkpoint.store import (adopt_expert_params, latest_step,
                                          migrate_expert_params, restore_checkpoint,
                                          save_checkpoint)
from repro_torch.comm import DistComm, LocalComm
from repro_torch.core import placement as PL
from repro_torch.device import disable_tf32, resolve_device, synchronize
from repro_torch.models.config import ArchConfig
from repro_torch.models.kv_pages import PageAllocator, pages_for_tokens
from repro_torch.models.registry import get_model
from repro_torch.models.transformer import (check_supported, init_decode_state,
                                            init_paged_decode_state)
from repro_torch.runtime.fault import (DegradedRecovery, FaultDetector, FaultReport,
                                      PreemptionGuard, StragglerWatchdog)
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
    # EPLB load counters (None when the config does not track heat)
    expert_heat: list | None = None        # per-logical-expert routed tokens
    heat_max_mean: float | None = None     # max/mean per-expert load
    rank_heat_max_mean: float | None = None  # max/mean per-EP-rank load
    # elastic fault tolerance (runtime/fault.py; docs/DESIGN.md §9)
    degraded_steps: int = 0                # decode steps served with < N alive
    recovery_count: int = 0                # shrink + expand transitions taken
    recovery_latency_s: float | None = None  # total wall time inside recovery
    recovery_events: list | None = None    # per-transition records (dicts)
    checkpoint_restores: int = 0           # recoveries that needed a restore
    alive_ranks: list | None = None        # EP ranks alive at the serve's end
    stragglers_flagged: int = 0            # watchdog outlier ITL steps
    preempted: bool = False                # SIGTERM drain-and-checkpoint exit
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
                 pipeline_depth: int = 1, comm=None, tracer=None, series=None,
                 rebalance_every: int = 0, num_redundant_experts: int = 0,
                 heat_decay: float = 0.0, min_replicas: int = 1, fault_domains=None,
                 max_slots_per_rank: int | None = None, fault_injector=None,
                 fault_detector: FaultDetector | None = None, miss_threshold: int = 2,
                 ckpt_dir: str | None = None):
        check_supported(cfg)
        self.device = resolve_device(device)
        self.tracer = NULL_TRACER if tracer is None else tracer
        self.series = NULL_SERIES if series is None else series
        self._win_itls: list[float] = []  # ITLs since the last window row
        disable_tf32()                    # the router matmul stays full f32
        self.cfg, self.batch = cfg, batch
        if comm is not None and ep_size != 1:
            raise ValueError("pass ep_size (hosted ranks) or comm, not both")
        self.comm = comm if comm is not None else (LocalComm(ep_size) if ep_size > 1
                                                   else None)
        if comm is None and ep_size > 1 and batch % ep_size:
            raise ValueError(f"batch {batch} must divide by ep_size {ep_size}")
        self._init_eplb(rebalance_every, num_redundant_experts, heat_decay,
                        min_replicas, fault_domains, max_slots_per_rank,
                        fault_injector, fault_detector, miss_threshold, ckpt_dir)
        # the rows of the global batch this process steps
        self.rows = self.comm.batch_rows(batch) if self.comm is not None else slice(0, batch)
        local = self.rows.stop - self.rows.start
        # without given params, each process draws the full logical tree
        # from the seed, adopts the initial placement under params_physical
        # and keeps its shard. Given params must be laid out as the config
        # says (logical, or the placement's slot order); under
        # params_physical the server takes ownership: adoptions rebind them
        # in place
        self.params = (init_params(cfg, seed, self.device, comm=self.comm)
                       if params is None else params)
        if cfg.moe is not None and cfg.moe.placement is not None:
            PL.device_tables(cfg.moe.placement, self.device)
        self.pipeline_depth = max(int(pipeline_depth), 1)
        self.state = self._init_state(local, max_len)
        # the step's token input, which a captured step reads in place
        self._tokens = torch.zeros((local, 1), dtype=torch.int32, device=self.device)
        # compiled serve steps, keyed by placement, bounded to {current,
        # previous}: see _compiled_step
        self._step_cache: collections.OrderedDict = collections.OrderedDict()
        self._serve_step = self._compiled_step()
        self.last_tokens: np.ndarray | None = None
        self.last_itls: np.ndarray | None = None
        self.guard = PreemptionGuard()    # SIGTERM/SIGINT -> drain + checkpoint

    def _init_eplb(self, rebalance_every, num_redundant_experts, heat_decay,
                   min_replicas, fault_domains, max_slots_per_rank, fault_injector=None,
                   fault_detector=None, miss_threshold=2, ckpt_dir=None) -> None:
        """The EPLB hook's and the fault path's settings, validated as the
        reference server does, and their scheduler (None when both are off
        or inert)."""
        cfg = self.cfg
        self.heat_decay = float(heat_decay)
        self.rebalance_every = int(rebalance_every)
        self.num_redundant_experts = int(num_redundant_experts)
        self.min_replicas = int(min_replicas)
        if self.min_replicas < 1:
            raise ValueError(f"min_replicas={min_replicas} must be >= 1")
        self.max_slots_per_rank = max_slots_per_rank
        self.fault_domains = fault_domains
        if self.rebalance_every and not (cfg.moe and cfg.moe.track_expert_heat):
            raise ValueError("rebalance_every requires an MoE config with "
                             "track_expert_heat=True (the heat drives the "
                             "rebalancer)")
        self.params_physical = bool(cfg.moe and cfg.moe.params_physical)
        self.placements: list = []          # placements adopted, in order
        self.migrations: list[dict] = []    # DistComm weight moves, per swap
        self._sched = None
        self._heat_drained = None           # float64 totals of drained counters
        self._rank_loads = None             # [N] float64, each window charged to
        #                                     the placement it ran under
        self.watchdog = StragglerWatchdog(
            tracer=self.tracer if self.tracer.enabled else None)
        # elastic EP: the injector is the deterministic fault source of
        # tests and benches, the detector the boundary heartbeat monitor
        self.ckpt_dir = ckpt_dir
        self._injector = fault_injector
        self._detector = fault_detector
        self.recoveries: list[dict] = []    # shrink/expand transition records
        self._degraded_steps = 0
        self._recovery_wall_s = 0.0
        self._ckpt_restores = 0
        self._stop = False                  # the boundary's agreed stop flag
        self.preempted = False
        n = self._ep_size()
        dist_comm = isinstance(self.comm, DistComm)
        if dist_comm and ckpt_dir is not None:
            raise NotImplementedError(
                "ckpt_dir over a DistComm: each process holds only its own expert "
                "slots, and a sharded checkpoint format is not the reference's "
                "(ROADMAP A10d)")
        if fault_injector is not None or fault_detector is not None:
            if not (cfg.moe and n > 1):
                raise ValueError("fault tolerance requires an MoE config on an EP "
                                 "mesh (ep extent > 1) — rank death is an "
                                 "EP-placement event")
            if self._detector is None:
                self._detector = FaultDetector(n, miss_threshold=miss_threshold)
            elif self._detector.num_ranks != n:
                raise ValueError(f"fault_detector watches {self._detector.num_ranks} "
                                 f"ranks but the EP extent is {n}")
        if (dist_comm and cfg.moe is not None and n > 1 and not self.params_physical
                and (self.rebalance_every or cfg.moe.placement is not None
                     or self._detector is not None)):
            raise NotImplementedError(
                "EPLB over a DistComm needs params_physical=True: logical-mode "
                "weights would fetch every remote expert each step (ROADMAP A10c)")
        if not (self.rebalance_every or self._detector is not None) or n <= 1:
            return                          # the hook is inert off the EP path
        E = cfg.moe.num_experts
        if (E + self.num_redundant_experts) % n:
            raise ValueError(
                f"num_experts={E} + num_redundant_experts={self.num_redundant_experts} "
                f"must divide by the EP extent {n}")
        if cfg.moe.placement is None and E % n:
            raise ValueError(
                f"num_experts={E} must divide by the EP extent {n} for the "
                "contiguous initial placement: pass an explicit MoESpec.placement")
        if self.fault_domains is None and self.min_replicas > 1:
            self.fault_domains = self._derived_domains(n)
        if self.min_replicas > 1:
            if self.num_redundant_experts < E * (self.min_replicas - 1):
                raise ValueError(
                    f"min_replicas={self.min_replicas} floor needs "
                    f"num_redundant_experts >= E*(min_replicas-1) = "
                    f"{E * (self.min_replicas - 1)}, got {self.num_redundant_experts}")
            if cfg.moe.placement is not None:
                # the initial placement must already hold the floor and
                # survive any single correlated failure
                PL.validate_floor(cfg.moe.placement, self.min_replicas,
                                  self.fault_domains, where="initial placement")
                PL.assert_shrink_feasible(
                    E, cfg.moe.placement.num_redundant, n, domains=self.fault_domains,
                    min_replicas=self.min_replicas,
                    max_slots_per_rank=self.max_slots_per_rank,
                    placement=cfg.moe.placement)
        self._sched = PL.RebalanceScheduler(
            E, n, num_redundant=self.num_redundant_experts, decay=self.heat_decay,
            initial=cfg.moe.placement, min_replicas=self.min_replicas,
            domains=self.fault_domains, max_slots_per_rank=self.max_slots_per_rank)

    # ---- engine hooks (ContinuousDecodeServer overrides both) ----

    def _init_state(self, batch: int, max_len: int):
        """Zeroed decode state for this engine's layout: the family's dense
        caches (``gemma3``'s rings among them)."""
        return init_decode_state(self.cfg, batch, max_len, self.device)

    def _step_factory(self):
        """The uncompiled serve step for this engine's layout;
        ``_compiled_step`` compiles this one."""
        return make_serve_step(self.cfg, self.comm)

    def _compiled_step(self) -> CompiledStep:
        """The compiled serve step for the current placement, cached per
        placement and bounded to two entries (current and previous): each
        captured graph pins its private memory pool. A placement key does
        not recur (the scheduler bumps the version of every changed table),
        so the previous entry is a grace retention; what matters is the
        bound."""
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

    # ---- EPLB hook: heat-driven placement swaps between steps ----

    def _ep_size(self) -> int:
        """The EP extent of the MoE layers (0 without EP)."""
        if not self.cfg.moe or self.comm is None:
            return 0
        return self.comm.size

    def _derived_domains(self, n: int):
        """Fault domains from the EP mesh: the pod (``rank // inner_size``)
        over more than one EP axis and pod, else every rank its own."""
        sizes = [s for _, s in self.comm.axes]
        inner = sizes[-1]
        if len(sizes) > 1 and n // inner > 1:
            return PL.domains_from_geometry(n, inner)
        return PL.trivial_domains(n)

    def _device_heat(self):
        """The decode state's heat counter on the host, float64, summed over
        the processes that carry other tokens (a collective: every process
        of a ``DistComm`` calls it at the same boundary); None without
        one."""
        heat = self.state.get("expert_heat") if isinstance(self.state, dict) else None
        if heat is None:
            return None
        if isinstance(self.comm, DistComm):
            heat = self.comm.all_reduce([heat], axis=self.comm.token_axes)[0]
        return PL.host_heat(heat)

    def _tracked_heat(self, dev=None):
        """[E] float64 routed-token totals: the live counter (``dev`` if
        already read) plus every window drained at a rebalance boundary
        (draining keeps the f32 counter at a window's magnitude)."""
        dev = self._device_heat() if dev is None else dev
        if dev is None:
            return None
        return dev if self._heat_drained is None else self._heat_drained + dev

    def _heat_metrics(self) -> dict:
        """ServeMetrics' heat fields at the end of a serve: the totals'
        max/mean, and the per-rank loads' (each drained window charged to
        the placement it ran under, the residual to the current one)."""
        dev = self._device_heat()
        heat = self._tracked_heat(dev)
        if heat is None:
            return {}
        out = dict(expert_heat=heat.tolist(), heat_max_mean=PL.imbalance(heat))
        n = self._ep_size()
        pl = self.cfg.moe.placement
        phys = pl.num_slots if pl is not None else self.cfg.moe.num_experts
        if n > 1 and phys % n == 0:
            rl = PL.rank_loads(dev, pl, n)
            if self._rank_loads is not None:
                rl = self._rank_loads + rl
            out["rank_heat_max_mean"] = PL.imbalance(rl)
        return out

    def _record_window(self, step_idx: int, kind: str, dev, rl) -> None:
        """One series row for a heat window that just ended, from the host
        arrays the boundary already drained (no device sync); drains the
        window's ITL buffer either way."""
        imb = None if rl is None else PL.imbalance(rl)
        if self.tracer.enabled and imb is not None:
            self.tracer.counter("rank_imbalance", float(imb))
        itls = self._win_itls
        self._win_itls = []
        if not self.series.enabled:
            return
        self.series.record(
            kind=kind, step=step_idx,
            window_tokens=None if dev is None else float(dev.sum()),
            heat_max_mean=None if dev is None else PL.imbalance(dev),
            imbalance=imb,
            rank_loads=None if rl is None else [float(x) for x in rl],
            itl_mean_s=float(np.mean(itls)) if itls else None,
            alive=len(self._detector.alive) if self._detector is not None else None,
            stragglers_flagged=self.watchdog.flagged,
            watchdog_rebased=self.watchdog.rebased,
            placements_adopted=len(self.placements))

    def _logical_spec(self):
        """The parameter specs of this server's config with the expert
        weights logical: where ``adopt_expert_params`` finds the expert
        axis."""
        cfg = dataclasses.replace(self.cfg, moe=dataclasses.replace(
            self.cfg.moe, params_physical=False))
        return get_model(cfg).params_spec(cfg)

    def _maybe_rebalance(self, step_idx: int) -> None:
        """Every ``rebalance_every`` steps: drain the heat counter into the
        host float64 totals, fold it into the scheduler and, only when the
        table changed, adopt the new placement (device tables, the physical
        weights rebound once, a new compiled step). A placement moves where
        experts compute, not what: the greedy token stream is unchanged."""
        if (self._sched is None or not self.rebalance_every
                or (step_idx + 1) % self.rebalance_every):
            return
        dev = self._device_heat()
        if dev is None:
            return
        with self.tracer.span("rebalance", step=step_idx):
            self._sched.observe(dev)
            self._heat_drained = (dev if self._heat_drained is None
                                  else self._heat_drained + dev)
            # this window's per-rank load under the placement it ran under
            rl = PL.rank_loads(dev, self.cfg.moe.placement, self._sched.num_ranks)
            self._rank_loads = rl if self._rank_loads is None else self._rank_loads + rl
            self._record_window(step_idx, "rebalance", dev, rl)
            self.state["expert_heat"].zero_()       # in place: graphs keep it
            pl = self._sched.advance()
            old = self.cfg.moe.placement
            if pl is old:
                return              # unchanged table: keep the compiled step
            self.cfg = dataclasses.replace(
                self.cfg, moe=dataclasses.replace(self.cfg.moe, placement=pl))
            self.placements.append(pl)
            self.tracer.instant("placement_swap", step=step_idx,
                                version=len(self.placements))
            PL.device_tables(pl, self.device)
            if self.params_physical:
                with self.tracer.span("adopt", step=step_idx):
                    self._adopt(step_idx, old, pl, "rebalance")
            self._serve_step = self._compiled_step()

    # ---- elastic fault tolerance: detect -> shrink/expand -> re-adopt ----

    def _poll_faults(self, step_idx: int):
        """Advance the injected fault schedule and poll the detector at a
        step boundary; returns the FaultReport when a rank newly died or
        rejoined, else None. Detection only: the caller drains the steps in
        flight before ``_recover``. The detector is re-polled until a quiet
        poll, and every report of the boundary merges into one
        (``FaultReport.merge``), so however many ranks die at a boundary the
        caller takes one transition. Over a ``DistComm`` the local report
        and stop flag then become the agreed ones (``_agree``); the stop
        flag of the boundary is left in ``self._stop``."""
        dist_comm = isinstance(self.comm, DistComm)
        merged = None
        if self._detector is not None:
            with self.tracer.span("fault_poll"):
                before = set(self._detector.dead)
                if self._injector is not None:
                    self._injector.advance(step_idx)
                    for r in range(self._detector.num_ranks):
                        if self._injector.is_alive(r):
                            self._detector.heartbeat(r, step_idx)
                merged = self._detector.poll(step_idx)
                while merged:
                    more = self._detector.poll(step_idx)
                    if not more:
                        break
                    merged = merged.merge(more)
                if dist_comm:
                    merged = self._agree(before)
        elif dist_comm:
            self._agree(set())
        if not dist_comm:
            self._stop = self.guard.should_stop
        if not merged:
            return None
        self.tracer.instant("fault_detected", step=step_idx, died=list(merged.died),
                            rejoined=list(merged.rejoined))
        return merged

    def _agree(self, before: set):
        """One decision for every process of a ``DistComm``: this process's
        stop flag and the dead ranks of its detector after the poll, folded
        over every process by one MAX all-reduce on the host
        (``control_max``). A rank dead in any process is dead in all, a stop
        in any process stops all. Every detector then holds the agreed dead
        set, and the report is that set against ``before``, the set agreed
        at the last boundary."""
        n = self._ep_size()
        dead = set(self._detector.dead) if self._detector is not None else set()
        got = self.comm.control_max([int(self.guard.should_stop)]
                                    + [int(r in dead) for r in range(n)])
        self._stop = bool(got[0])
        if self._detector is None:
            return None
        agreed = {r for r in range(n) if got[1 + r]}
        self._detector.set_dead(agreed)
        return FaultReport(tuple(sorted(agreed - before)), tuple(sorted(before - agreed)))

    def _recover(self, step_idx: int, report) -> None:
        """One shrink or expand transition (docs/DESIGN.md §9): drain the
        heat window, narrow or widen the scheduler to the detector's alive
        set, build the new table and re-adopt the physical expert weights
        through the masked old table (surviving replicas only). When an
        expert lost its last replica, warn ``DegradedRecovery`` and restore
        the whole tree from ``ckpt_dir`` (rebound to the new table) or
        raise. Logical-mode weights keep the whole [E, ...] tree, so only
        the placement changes. Then the device tables and a new step."""
        t0 = time.perf_counter()
        kind = "shrink" if report.died else "expand"
        # each phase's seconds, each also a nested span: repack (scheduler
        # and table), adopt (the masked rebind) or restore (the checkpoint)
        phases: dict[str, float] = {}
        with self.tracer.span(f"recover:{kind}", step=step_idx, died=list(report.died),
                              rejoined=list(report.rejoined)):
            dev = self._device_heat()
            if dev is not None:
                self._sched.observe(dev)
                self._heat_drained = (dev if self._heat_drained is None
                                      else self._heat_drained + dev)
                rl = PL.rank_loads(dev, self.cfg.moe.placement, self._sched.num_ranks)
                self._rank_loads = rl if self._rank_loads is None else self._rank_loads + rl
                self._record_window(step_idx, f"recover:{kind}", dev, rl)
                self.state["expert_heat"].zero_()    # in place: graphs keep it
            tp = time.perf_counter()
            with self.tracer.span("recover:repack"):
                self._sched.set_alive(self._detector.alive)
                old = self.cfg.moe.placement
                pl = self._sched.advance()
            phases["repack_s"] = time.perf_counter() - tp
            event = dict(step=step_idx, kind=kind, died=list(report.died),
                         rejoined=list(report.rejoined), alive=list(self._detector.alive),
                         lost_experts=[], restored_from=None,
                         placement_changed=pl is not old, phases=phases)
            if pl is not old:
                new_cfg = dataclasses.replace(self.cfg, moe=dataclasses.replace(
                    self.cfg.moe, placement=pl))
                if self.params_physical:
                    src_live = (old if old is not None else PL.identity_placement(
                        self.cfg.moe.num_experts, self._sched.num_ranks))
                    lost = (PL.lost_experts(src_live, self._sched.alive)
                            if report.died else ())
                    if lost:
                        self._restore_lost(step_idx, report, lost, event, new_cfg, t0)
                    else:
                        src = (PL.mask_placement(src_live, self._sched.alive)
                               if report.died else old)
                        tp = time.perf_counter()
                        with self.tracer.span("recover:adopt"):
                            self._adopt(step_idx, src, pl, kind)
                        phases["adopt_s"] = time.perf_counter() - tp
                self.cfg = new_cfg
                self.placements.append(pl)
                self.tracer.instant("placement_swap", step=step_idx,
                                    version=len(self.placements))
                PL.device_tables(pl, self.device)
                self._serve_step = self._compiled_step()
        dt = time.perf_counter() - t0
        event["latency_s"] = dt
        self._recovery_wall_s += dt
        self.recoveries.append(event)

    def _adopt(self, step_idx: int, src, dst, kind: str) -> None:
        """Rebind the physical expert weights from ``src``'s slot order to
        ``dst``'s: in place on one card, migrated between the processes of
        a ``DistComm`` (its bytes and seconds kept in ``migrations``)."""
        if isinstance(self.comm, DistComm):
            self.params, moved = migrate_expert_params(
                self.params, self._logical_spec(), src, dst, self.comm)
            self.migrations.append(dict(step=step_idx, kind=kind, **moved))
        else:
            self.params = adopt_expert_params(self.params, self._logical_spec(), src, dst)
        synchronize(self.device)             # the span holds the copies

    def _restore_lost(self, step_idx: int, report, lost, event: dict, new_cfg,
                      t0: float) -> None:
        """The dead ranks held every replica of ``lost``: warn, then restore
        the whole tree from the latest checkpoint, rebound to ``new_cfg``'s
        table, or record the failed transition and raise."""
        event["lost_experts"] = list(lost)
        ck = latest_step(self.ckpt_dir) if self.ckpt_dir is not None else None
        warnings.warn(DegradedRecovery(
            f"rank death {list(report.died)} lost every replica of experts "
            f"{list(lost)[:8]} — zero-data-loss shrink impossible; "
            + (f"restoring from checkpoint step {ck}" if ck is not None else
               f"no checkpoint available (ckpt_dir={self.ckpt_dir!r})")))
        if ck is None:
            event["latency_s"] = time.perf_counter() - t0
            self.recoveries.append(event)
            raise RuntimeError(
                f"experts {list(lost)[:8]} unrecoverable from surviving ranks and no "
                f"checkpoint to restore from (ckpt_dir={self.ckpt_dir!r}) — pass "
                "ckpt_dir= with a saved checkpoint or add redundant replicas "
                "(num_redundant_experts)")
        tp = time.perf_counter()
        with self.tracer.span("checkpoint", restore=True, ckpt_step=ck):
            self.params = None               # the old tree goes before the new loads
            self.params, _ = restore_checkpoint(
                self.ckpt_dir, ck, get_model(new_cfg).params_spec(new_cfg),
                placement=new_cfg.moe.placement, device=self.device)
        event["phases"]["restore_s"] = time.perf_counter() - tp
        event["restored_from"] = ck
        self._ckpt_restores += 1

    def _preempt(self, step_idx: int) -> None:
        """The SIGTERM/SIGINT exit, with the steps in flight drained by the
        caller: write a placement-tagged checkpoint (``ckpt_dir``) and mark
        the server preempted; the loop returns at this boundary."""
        self.preempted = True
        if self.ckpt_dir is None:
            return
        pl = self.cfg.moe.placement if self.cfg.moe else None
        with self.tracer.span("checkpoint", step=step_idx, preempt=True):
            save_checkpoint(
                self.ckpt_dir, step_idx + 1, self.params,
                placement=pl if self.params_physical else None,
                extra=dict(preempted=True,
                           alive_ranks=(list(self._detector.alive)
                                        if self._detector is not None else None)))

    def _fault_metrics(self) -> dict:
        """ServeMetrics' fault fields at the end of a serve."""
        return dict(
            degraded_steps=self._degraded_steps, recovery_count=len(self.recoveries),
            recovery_latency_s=self._recovery_wall_s or None,
            recovery_events=list(self.recoveries) or None,
            checkpoint_restores=self._ckpt_restores,
            alive_ranks=list(self._detector.alive) if self._detector is not None else None,
            preempted=self.preempted)

    def _count_degraded(self) -> None:
        if self._detector is not None and self._detector.dead:
            self._degraded_steps += 1

    def close(self) -> None:
        """Release the captured graphs and their memory pools (the next step
        captures again) and uninstall the preemption handlers (whatever was
        registered before this server comes back). Call when retiring a
        server in a longer-lived process."""
        self._step_cache.clear()
        self._serve_step = self._compiled_step()
        self.guard.restore()

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
        record_itls = self.series.enabled
        for i in range(steps):
            t0 = time.perf_counter()
            with self.tracer.span("serve_step"):
                tok = self.step(tok)
                # the boundary's poll is host work: it runs while the card steps
                report = self._poll_faults(i)
                synchronize(self.device)
            itls.append(time.perf_counter() - t0)
            if record_itls:
                self._win_itls.append(itls[-1])
            outs.append(tok)
            if report is not None:
                # the recovery drains the heat window and advances the table
                # itself: a periodic boundary at the same step would dedup
                self._recover(i, report)
            else:
                self._maybe_rebalance(i)
            self._count_degraded()
            if self._stop:
                self._preempt(i)
                break
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
        for i in range(steps):
            tok = self.step(tok)
            ev = torch.cuda.Event() if cuda else None
            if ev is not None:
                ev.record()
            pending.append((tok, ev))
            report = self._poll_faults(i)    # host work, before blocking on a step
            if len(pending) >= self.pipeline_depth:
                retire_oldest()
            boundary = (self._sched is not None and self.rebalance_every
                        and (i + 1) % self.rebalance_every == 0)
            if boundary or report is not None or self._stop:
                # a swap, a recovery or a preemption: the steps in flight
                # land under the placement that issued them first. The drain
                # and the recapture are charged to the ITL stream on purpose
                with self.tracer.span("drain", pending=len(pending)):
                    while pending:
                        retire_oldest()
                if report is not None:
                    self._recover(i, report)
                elif boundary:
                    self._maybe_rebalance(i)
                if self._stop:
                    self._preempt(i)
                    break
            self._count_degraded()
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
        self.last_itls = itls
        total = toks.shape[0] * toks.shape[1]
        for t in itls:                    # the straggler signal over the ITLs
            self.watchdog.observe(float(t))
        return ServeMetrics(
            ttft_s=ttft, itl_mean_s=float(itls.mean()),
            itl_p99_s=float(np.percentile(itls, 99)),
            output_tok_s=total / (ttft + decode_wall), total_tokens=total,
            **self._heat_metrics(), **self._fault_metrics(),
            stragglers_flagged=self.watchdog.flagged,
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
        if get_model(cfg).paged_decode_step is None:
            raise NotImplementedError(f"family {cfg.family!r} has no paged decode path")
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
        (or ``max_steps``, or a preemption). Fault recoveries, placement
        swaps and preemption run at the boundaries admission and retirement
        use: the page tables are host state, so no transition touches
        them."""
        allocator = PageAllocator(self.num_pages, self.page_size)
        sched = ContinuousScheduler(requests, self.batch, self.max_pages,
                                    allocator,
                                    tracer=self.tracer if self.tracer.enabled else None)
        self.reqsched = sched
        record = self.series.enabled
        t0 = last = time.perf_counter()
        marks: list[float] = []
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
                # the boundary's poll is host work: it runs while the card steps
                report = self._poll_faults(step_idx)
                out = tok.cpu().numpy()              # waits for the step
            now = time.perf_counter()
            sched.observe(out, now)
            if record:
                # host state only: the engine's occupancy at this boundary
                self._win_itls.append(now - last)
                self.series.record(
                    kind="step", step=step_idx, itl_s=now - last,
                    queue_depth=len(sched.queue), active=sched.live_count,
                    pages_live=allocator.live_count,
                    pages_peak=allocator.peak_live)
            marks.append(now)
            last = now
            if report is not None:
                self._recover(step_idx, report)
            else:
                self._maybe_rebalance(step_idx)
            self._count_degraded()
            if self._stop:
                self._preempt(step_idx)
                break
            step_idx += 1
        wall = time.perf_counter() - t0
        step_itls = np.diff(np.asarray(marks)) if len(marks) > 1 else np.asarray([0.0])
        for t in step_itls:
            self.watchdog.observe(float(t))
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
            **self._heat_metrics(), **self._fault_metrics(),
            stragglers_flagged=self.watchdog.flagged,
            timeline=self.tracer.summary() or None,
            series=list(self.series.rows) or None)
