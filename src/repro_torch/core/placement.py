"""EPLB: expert placement and load balancing (port of
``src/repro/core/placement.py``).

The contiguous layout (expert e at rank e // L) is ``placement=None`` on the
group config. ``EpPlacement`` makes placement an explicit, swappable table:
logical expert -> [(rank, local slot)], with optional redundant replicas,
hashable so it can ride in the frozen ``EpGroupConfig``.

* replica selection: ``assign`` resolves (expert, source rank) to one
  physical (rank, slot) as ``src_rank % replica_count``, a pure function of
  the gathered routing, so both ends of every transfer agree with no extra
  exchange. It runs at plan time only, on device tables that
  ``device_tables`` builds once per placement and device; the phase bodies
  stay single passes over the plan's maps.
* heat: per-logical-expert routed-token counts (``heat_from_topk``,
  ``fold_slot_counts``), accumulated on the host by ``HeatTracker``.
* ``rebalance``: the greedy policy. Each redundant slot goes to the expert
  with the highest load per replica, then every replica is LPT-packed onto
  the ranks, replicas of one expert on distinct ranks where it can.
* fault domains, the replica floor and the degraded tables of elastic EP
  (``shrink_placement``, ``expand_placement``, ``mask_placement``) are pure
  functions over the tables; the recovery that calls them is ROADMAP A10b.

Everything here is host-side numpy except ``assign``, ``heat_from_topk``,
``device_tables`` and ``expand``/``collapse_expert_params``, which take or
make torch tensors. The policy reads no clock and no randomness, so every
process of a ``DistComm`` mesh fed the same heat takes the same table.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import zlib
from typing import NamedTuple

import numpy as np
import torch

# dict keys of the expert-stacked MoE weights (models/moe.py moe_spec) —
# the leaves the placement/checkpoint rebinding helpers act on by default
# (canonical here; checkpoint.store re-exports it)
EXPERT_PARAM_KEYS = ("w_gate", "w_up", "w_down")

# Sentinel for a slot that hosts NOTHING: degraded placements (a dead rank's
# row is all EMPTY) and the masked view of a placement restricted to its
# survivors. An empty slot never appears in any expert's replica list, so
# plan-time assignment (``assign``/``plan.dest_of``) can never route a token
# to it — zero traffic to a dead rank by construction (docs/DESIGN.md §9).
EMPTY = -1


# --------------------------------------------------------------------------
# fault domains: the correlated-failure topology (docs/DESIGN.md §9)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FaultDomains:
    """Rank -> failure-domain map: ranks in one domain fail TOGETHER (a whole
    NVLink pod losing power, a switch taking its rail down — UBEP's
    correlated-failure model, PAPERS.md). Replica-placement constraints
    (`rebalance(min_replicas=..., domains=...)`) and the shrink-feasibility
    precheck (`shrink_feasibility`) treat the domain, not the rank, as the
    unit of failure. Hashable (tuple) so it can ride in the static
    ``EpGroupConfig``; the default derivation from the HT hierarchy is
    ``EpGroup.fault_domains()`` (pod = rank // inner_size — the same
    arithmetic the hierarchical plan uses, `core/plan.py rank_pod`)."""

    domain_of: tuple[int, ...]      # [num_ranks] rank -> domain id

    def __post_init__(self):
        if not self.domain_of:
            raise ValueError("fault-domain map must be non-empty")
        if any(d < 0 for d in self.domain_of):
            raise ValueError(f"domain ids must be >= 0, got {self.domain_of}")

    @property
    def num_ranks(self) -> int:
        return len(self.domain_of)

    @property
    def num_domains(self) -> int:
        return len(set(self.domain_of))

    def domains(self) -> tuple[int, ...]:
        return tuple(sorted(set(self.domain_of)))

    def ranks_in(self, domain: int) -> tuple[int, ...]:
        return tuple(r for r, d in enumerate(self.domain_of) if d == domain)

    def live_domains(self, alive_ranks) -> tuple[int, ...]:
        """Domains with at least one alive rank."""
        alive = set(alive_ranks)
        return tuple(sorted({d for r, d in enumerate(self.domain_of)
                             if r in alive}))

    def describe(self) -> str:
        """Compact rendering for error messages: ``{domain: [ranks]}``."""
        return "{" + ", ".join(f"{d}: {list(self.ranks_in(d))}"
                               for d in self.domains()) + "}"


def trivial_domains(num_ranks: int) -> FaultDomains:
    """Every rank its own domain — the flat (non-hierarchical) topology,
    where the only correlated-failure unit is the single rank. Under this
    map "distinct domains" and "distinct ranks" coincide, so the floor
    degenerates to exactly the rank-level constraint."""
    if num_ranks < 1:
        raise ValueError(f"num_ranks={num_ranks} must be >= 1")
    return FaultDomains(tuple(range(num_ranks)))


def domains_from_geometry(ep_size: int, inner_size: int) -> FaultDomains:
    """The HT hierarchy's natural fault boundary: pod = rank // inner_size
    (must agree with `core/plan.py rank_pod`, pinned by
    tests/test_fault_domains.py)."""
    if inner_size < 1 or ep_size % inner_size:
        raise ValueError(f"inner_size={inner_size} must divide "
                         f"ep_size={ep_size}")
    from repro_torch.core.plan import rank_pod
    return FaultDomains(tuple(rank_pod(r, inner_size)
                              for r in range(ep_size)))


@dataclasses.dataclass(frozen=True)
class EpPlacement:
    """Physical expert layout: ``slot_expert[r][s]`` is the logical expert
    hosted in rank *r*'s local slot *s*. Hashable (nested tuples) so it can
    ride in the static ``EpGroupConfig``; every logical expert must appear in
    at least one slot, and slots beyond the first are redundant replicas.
    ``version`` distinguishes successive rebalances that happen to emit the
    same table (it feeds the placement fingerprint that salts the routing
    hash, so a swap always forces handle rebuild)."""

    num_experts: int
    slot_expert: tuple[tuple[int, ...], ...]    # [num_ranks][slots_per_rank]
    version: int = 0

    def __post_init__(self):
        E, tbl = self.num_experts, self.slot_expert
        if not tbl or not tbl[0]:
            raise ValueError("placement table must be non-empty")
        S = len(tbl[0])
        if any(len(r) != S for r in tbl):
            raise ValueError("placement rows must have equal slot counts")
        seen = np.zeros(E, bool)
        for row in tbl:
            for e in row:
                if e == EMPTY:
                    continue            # degraded: slot hosts nothing
                if not (0 <= e < E):
                    raise ValueError(f"slot expert {e} out of range [0, {E})")
                seen[e] = True
        if not seen.all():
            missing = np.nonzero(~seen)[0][:8].tolist()
            raise ValueError(f"experts {missing} have no placement slot")

    @property
    def num_ranks(self) -> int:
        return len(self.slot_expert)

    @property
    def slots_per_rank(self) -> int:
        return len(self.slot_expert[0])

    @property
    def num_slots(self) -> int:
        return self.num_ranks * self.slots_per_rank

    @property
    def num_empty(self) -> int:
        """Empty (EMPTY-sentinel) slots — nonzero only on degraded tables."""
        return sum(1 for row in self.slot_expert for e in row if e == EMPTY)

    @property
    def num_redundant(self) -> int:
        """Replica surplus over one-slot-per-expert, counting LIVE slots
        only (empty slots host nothing, so they are capacity, not
        redundancy)."""
        return self.num_slots - self.num_empty - self.num_experts

    def dead_ranks(self) -> tuple[int, ...]:
        """Ranks whose every slot is empty — the degraded-placement marker
        (a rank with zero slots assigned receives zero traffic)."""
        return tuple(r for r, row in enumerate(self.slot_expert)
                     if all(e == EMPTY for e in row))

    def alive_ranks(self) -> tuple[int, ...]:
        dead = set(self.dead_ranks())
        return tuple(r for r in range(self.num_ranks) if r not in dead)

    def is_identity(self) -> bool:
        """True iff this is exactly the contiguous striping (no replicas)."""
        if self.num_slots != self.num_experts:
            return False
        S = self.slots_per_rank
        return all(e == r * S + s
                   for r, row in enumerate(self.slot_expert)
                   for s, e in enumerate(row))

    def fingerprint(self) -> int:
        """Nonzero uint32 identifying (table, version) — the salt that the
        routing hash mixes in so a placement swap always forces handle
        rebuild. Deterministic across processes (crc32, not Python hash)."""
        flat = np.asarray([e for row in self.slot_expert for e in row],
                          np.int64)
        fp = zlib.crc32(flat.tobytes())
        fp ^= (self.version * 0x9E3779B1) & 0xFFFFFFFF
        return fp or 1


def placement_to_jsonable(placement: EpPlacement) -> dict:
    """JSON-safe rendering of a placement table (checkpoint indexes, bench
    result files). Round-trips exactly through ``placement_from_jsonable``."""
    return dict(num_experts=placement.num_experts,
                slot_expert=[list(row) for row in placement.slot_expert],
                version=placement.version)


def placement_from_jsonable(d: dict) -> EpPlacement:
    return EpPlacement(int(d["num_experts"]),
                       tuple(tuple(int(e) for e in row)
                             for row in d["slot_expert"]),
                       version=int(d.get("version", 0)))


def identity_placement(num_experts: int, num_ranks: int) -> EpPlacement:
    """The explicit rendering of the default contiguous striping: expert e at
    (e // L, e % L). Bitwise-identical behavior to ``placement=None`` is
    pinned by tests/test_placement.py."""
    if num_experts % num_ranks:
        raise ValueError(f"num_experts={num_experts} must divide by "
                         f"num_ranks={num_ranks}")
    L = num_experts // num_ranks
    return EpPlacement(num_experts, tuple(
        tuple(range(r * L, (r + 1) * L)) for r in range(num_ranks)))


# --------------------------------------------------------------------------
# derived tables + plan-time assignment
# --------------------------------------------------------------------------

class PlacementTables(NamedTuple):
    """Numpy renderings of the placement, cached per EpPlacement. Row E of
    each replica table is the padding-sentinel expert: rank=num_ranks,
    slot=slots_per_rank — out of range everywhere, exactly like ``E // L``
    under the contiguous layout."""

    replica_rank: np.ndarray    # [E+1, Rmax] int32
    replica_slot: np.ndarray    # [E+1, Rmax] int32
    replica_count: np.ndarray   # [E+1] int32 (>= 1)
    slot_expert: np.ndarray     # [N, S] int32
    primary_row: np.ndarray     # [E] int32 — flat (rank*S + slot) of replica 0


@functools.lru_cache(maxsize=128)
def tables(placement: EpPlacement) -> PlacementTables:
    E, N, S = placement.num_experts, placement.num_ranks, placement.slots_per_rank
    reps: list[list[tuple[int, int]]] = [[] for _ in range(E)]
    for r, row in enumerate(placement.slot_expert):
        for s, e in enumerate(row):
            if e == EMPTY:
                continue                     # degraded slot: hosts nothing
            reps[e].append((r, s))           # rank-major replica order
    rmax = max(len(x) for x in reps)
    rank_t = np.full((E + 1, rmax), N, np.int32)
    slot_t = np.full((E + 1, rmax), S, np.int32)
    count_t = np.ones((E + 1,), np.int32)
    for e, rs in enumerate(reps):
        count_t[e] = len(rs)
        for j, (r, s) in enumerate(rs):
            rank_t[e, j], slot_t[e, j] = r, s
        for j in range(len(rs), rmax):       # pad with the primary replica
            rank_t[e, j], slot_t[e, j] = rs[0]
    se = np.asarray(placement.slot_expert, np.int32)
    primary = np.asarray([rs[0][0] * S + rs[0][1] for rs in reps], np.int32)
    return PlacementTables(rank_t, slot_t, count_t, se, primary)


class DeviceTables(NamedTuple):
    """``PlacementTables`` on a device, for plan-time lookups inside a step
    (a captured step must not copy host data to the card)."""

    replica_rank: torch.Tensor    # [E+1, Rmax] int32
    replica_slot: torch.Tensor    # [E+1, Rmax] int32
    replica_count: torch.Tensor   # [E+1] int32
    slot_perm: torch.Tensor       # [N*S] int64: each slot's expert, EMPTY -> 0
    primary_row: torch.Tensor     # [E] int64


# device tables by (placement, device): bounded, and far above the two
# placements a server's step cache keeps captured
_DEVICE_TABLES: collections.OrderedDict = collections.OrderedDict()
_DEVICE_TABLES_MAX = 16


def device_tables(placement: EpPlacement, device) -> DeviceTables:
    """The placement's tables on ``device``, built on the first call for a
    (placement, device) pair and cached: call it when a placement is
    adopted, outside any captured step, and every lookup inside the step
    finds them."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (placement, dev)
    hit = _DEVICE_TABLES.get(key)
    if hit is not None:
        _DEVICE_TABLES.move_to_end(key)
        return hit
    tb = tables(placement)
    perm = tb.slot_expert.reshape(-1)
    out = DeviceTables(
        *(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
          for a in (tb.replica_rank, tb.replica_slot, tb.replica_count)),
        slot_perm=torch.from_numpy(np.where(perm == EMPTY, 0, perm).astype(np.int64)).to(dev),
        primary_row=torch.from_numpy(tb.primary_row.astype(np.int64)).to(dev))
    _DEVICE_TABLES[key] = out
    while len(_DEVICE_TABLES) > _DEVICE_TABLES_MAX:
        _DEVICE_TABLES.popitem(last=False)
    return out


def assign(placement: EpPlacement, experts: torch.Tensor, src_rank):
    """Resolve global expert ids [...] to physical (rank, slot) at plan time.

    ``experts`` may include the padding sentinel ``num_experts`` (-> rank N,
    slot S, out of range everywhere). ``src_rank`` (an int or a tensor
    broadcastable to ``experts``) picks the replica as ``src_rank %
    replica_count``: a pure function of replicated metadata, so every rank
    derives the same answer and a hot expert's senders round-robin over its
    replicas. Returns int32 tensors of ``experts``' broadcast shape."""
    tb = device_tables(placement, experts.device)
    e = experts.clamp(0, placement.num_experts).to(torch.int64)
    j = src_rank % tb.replica_count[e].to(torch.int64)
    e, j = torch.broadcast_tensors(e, j)
    return tb.replica_rank[e, j], tb.replica_slot[e, j]


# --------------------------------------------------------------------------
# heat: per-logical-expert load statistics
# --------------------------------------------------------------------------

def heat_from_topk(topk_idx: torch.Tensor, num_experts: int) -> torch.Tensor:
    """[E] f32 routed-token histogram from a routing tensor (any leading
    shape), built by an in-place ``index_add_``; out-of-range ids (the
    padding sentinel) land in a trash bin that is cut off."""
    flat = topk_idx.reshape(-1).to(torch.int64)
    ok = (flat >= 0) & (flat < num_experts)
    idx = torch.where(ok, flat, num_experts)
    heat = torch.zeros((num_experts + 1,), dtype=torch.float32, device=flat.device)
    heat.index_add_(0, idx, ok.to(torch.float32))
    return heat[:num_experts]


def fold_slot_counts(placement: EpPlacement | None, counts_by_rank):
    """Fold per-physical-slot receive counts [N, S] (each rank's
    ``recv_counts`` / ``tokens_per_expert``) into logical per-expert heat
    [E]: replicas of one expert sum. ``placement=None`` = contiguous."""
    c = np.asarray(counts_by_rank, np.float64)
    if placement is None:
        return c.reshape(-1)
    heat = np.zeros(placement.num_experts, np.float64)
    se = tables(placement).slot_expert.reshape(-1)
    live = se != EMPTY      # empty slots receive nothing; don't let the
    #                         sentinel alias an expert id under np.add.at
    np.add.at(heat, se[live], c.reshape(-1)[live])
    return heat


def host_heat(heat) -> np.ndarray:
    """A heat vector (numpy, a list or a tensor on any device) as float64
    numpy on the host."""
    if isinstance(heat, torch.Tensor):
        return heat.detach().to("cpu", torch.float64).numpy()
    return np.asarray(heat, np.float64)


class HeatTracker:
    """Host-side heat accumulator: fold per-step heat vectors, optionally
    with exponential decay so stale traffic ages out of the rebalancer's
    view. ``totals`` is the current [E] float64 heat."""

    def __init__(self, num_experts: int, decay: float = 0.0):
        if not 0.0 <= decay < 1.0:
            raise ValueError(f"decay={decay} must be in [0, 1)")
        self.totals = np.zeros(num_experts, np.float64)
        self.decay = decay

    def update(self, heat) -> np.ndarray:
        h = host_heat(heat)
        if h.shape != self.totals.shape:
            raise ValueError(f"heat shape {h.shape} != {self.totals.shape}")
        if self.decay:
            self.totals *= 1.0 - self.decay
        self.totals += h
        return self.totals


def rank_loads(heat, placement: EpPlacement | None, num_ranks: int | None = None):
    """Expected per-rank load [N] under a placement: each expert's heat
    splits evenly over its replicas (the round-robin selection's steady
    state). ``placement=None`` (contiguous) needs ``num_ranks``."""
    h = np.asarray(heat, np.float64)
    if placement is None:
        assert num_ranks is not None
        return h.reshape(num_ranks, -1).sum(axis=1)
    tb = tables(placement)
    share = h / np.maximum(tb.replica_count[:-1], 1)
    live = tb.slot_expert != EMPTY
    return (share[np.where(live, tb.slot_expert, 0)] * live).sum(axis=1)


def imbalance(loads) -> float:
    """max/mean load ratio (1.0 = perfectly balanced)."""
    loads = np.asarray(loads, np.float64)
    mean = loads.mean()
    return float(loads.max() / mean) if mean > 0 else 1.0


# --------------------------------------------------------------------------
# rebalancer: heat -> placement (optionally fault-domain constrained)
# --------------------------------------------------------------------------

def _floor_ctx(E: int, num_redundant: int, num_ranks: int, alive,
               domains: FaultDomains | None, min_replicas: int) -> str:
    """The E/R/N/domains tail every floor error message carries."""
    return (f"[E={E} experts, R={num_redundant} redundant slots, "
            f"N={len(alive)} alive of {num_ranks} ranks, "
            f"min_replicas={min_replicas}, domains="
            f"{domains.describe() if domains is not None else None}]")


def _warn_degraded(msg: str):
    """Loud DegradedRecovery-class warning without a core->runtime import
    cycle (runtime/fault.py imports nothing from here either way, but the
    category is defined there — the serving layer owns the recovery
    vocabulary)."""
    import warnings

    from repro_torch.runtime.fault import DegradedRecovery
    warnings.warn(DegradedRecovery(msg), stacklevel=3)


def required_domain_span(E: int, min_replicas: int, alive,
                         domains: FaultDomains | None,
                         domain_caps: dict | None = None, *,
                         warn: bool = False) -> int:
    """How many DISTINCT fault domains each expert's replicas must span.

    The target is ``min(min_replicas, live domain count)`` — "distinct
    domains when domains permit" (docs/DESIGN.md §9). Domains stop permitting
    when capacity does: each expert claims one slot in each of ``span``
    domains and a domain can serve at most ``min(cap_D, E)`` such claims, so
    the span is lowered (never below 1) until
    ``sum_D min(cap_D, E) >= E * span`` holds. ``domain_caps`` maps live
    domain -> slot capacity; with ``warn=True`` a capacity-forced lowering
    emits a loud DegradedRecovery-class warning (uneven pods weaken the
    correlated-failure guarantee and that must never be silent)."""
    if domains is None or min_replicas <= 1:
        return 1
    live = domains.live_domains(alive)
    target = min(min_replicas, len(live))
    if target <= 1:
        return 1
    caps = [domain_caps[d] for d in live] if domain_caps is not None else None
    span = target
    if caps is not None:
        while span > 1 and sum(min(c, E) for c in caps) < E * span:
            span -= 1
    if span < target and warn:
        _warn_degraded(
            f"fault domains too uneven to give every expert {target} "
            f"distinct domains (per-domain slot capacities "
            f"{dict(zip(live, caps))}, E={E}) — enforcing span {span}; "
            "a whole-domain failure may lose some experts' last replica")
    return span


def rebalance(heat, num_ranks: int, *, num_redundant: int = 0,
              version: int = 1,
              alive_ranks: tuple[int, ...] | None = None,
              min_replicas: int = 1,
              domains: FaultDomains | None = None,
              max_slots_per_rank: int | None = None,
              check_shrink: bool | None = None) -> EpPlacement:
    """Greedy placement minimizing the max per-rank load.

    1. Replica counts: every expert gets ``min_replicas`` slots (the
       min-replica floor); each remaining redundant slot goes to the expert
       with the current highest per-replica load (heat / replicas) —
       DeepSeek-EPLB-style redundancy for the hottest experts. Under the
       floor, replica counts are capped at the alive-rank count (a replica
       beyond that could only co-host).
    2. Packing: replicas sorted by descending per-replica load are LPT-packed
       onto ranks (least-loaded rank with a free slot wins). Replicas of one
       expert land on distinct ranks — a hard constraint under the floor
       (``min_replicas > 1``; an impossible table raises loudly), a
       preference in legacy floor-less mode where a FORCED co-hosting now
       emits a loud DegradedRecovery-class warning (co-hosted replicas are
       dead weight for both load-splitting and fault tolerance). Fully
       deterministic: ties break by expert id then rank id.

    ``alive_ranks`` (elastic EP, docs/DESIGN.md §9): pack onto that subset
    only — the table still spans ``num_ranks`` rows (the group's static
    geometry is unchanged) but every dead rank's row is all ``EMPTY``, so
    plan-time assignment routes it zero traffic. ``num_experts +
    num_redundant`` must then divide by the survivor count
    (``shrink_placement`` auto-fits the redundancy budget).

    Fault domains (docs/DESIGN.md §9): with ``domains`` and a floor, each
    expert's first ``required_domain_span(...)`` replicas are forced into
    DISTINCT fault domains — a whole-domain (pod) failure then leaves every
    expert a surviving replica, so recovery is the zero-data-loss masked
    rebind, never a checkpoint restore. Extra replicas prefer fresh domains.
    Infeasible floors (too few redundant slots / alive ranks / domain
    capacity) raise loudly, naming E/R/N/domains.

    Shrink-feasibility precheck: under a floor (default) the produced table
    is validated with ``assert_shrink_feasible`` BEFORE being returned — a
    subsequent whole-domain failure must leave a survivor set onto which the
    shrink can re-pack without violating the floor or over-packing past
    ``max_slots_per_rank``. Adoption-time is where infeasibility surfaces,
    never mid-recovery. ``check_shrink=False`` opts out (the degraded
    re-pack after an actual death keeps the floor checks but skips the
    what-if)."""
    h = np.asarray(heat, np.float64)
    E = h.size
    P = E + num_redundant
    if num_redundant < 0:
        raise ValueError(f"num_redundant={num_redundant} must be >= 0")
    if min_replicas < 1:
        raise ValueError(f"min_replicas={min_replicas} must be >= 1")
    alive = (tuple(range(num_ranks)) if alive_ranks is None
             else tuple(sorted(set(alive_ranks))))
    if not alive or any(not 0 <= r < num_ranks for r in alive):
        raise ValueError(f"alive_ranks={alive_ranks} must be a non-empty "
                         f"subset of range({num_ranks})")
    if domains is not None and domains.num_ranks != num_ranks:
        raise ValueError(f"domains cover {domains.num_ranks} ranks, "
                         f"rebalance spans num_ranks={num_ranks}")
    m = min_replicas
    ctx = _floor_ctx(E, num_redundant, num_ranks, alive, domains, m)
    if m > 1:
        if len(alive) < m:
            raise ValueError(
                f"min_replicas={m} floor infeasible: needs {m} distinct "
                f"ranks per expert but only {len(alive)} are alive {ctx}")
        if num_redundant < E * (m - 1):
            raise ValueError(
                f"min_replicas={m} floor infeasible: needs num_redundant >= "
                f"E*(min_replicas-1) = {E * (m - 1)}, got {num_redundant} "
                f"{ctx}")
    if P % len(alive):
        raise ValueError(
            f"num_experts+num_redundant={P} must divide by the "
            f"{'alive rank count' if alive_ranks is not None else 'rank count'}"
            f"={len(alive)}")
    S = P // len(alive)
    if m > 1:
        if S > E:
            raise ValueError(
                f"min_replicas={m} floor infeasible: {S} slots per alive "
                f"rank exceed the {E} experts — some rank would have to "
                f"co-host replicas of one expert {ctx}")

    # ---- replica counts: floor first, extras to the hottest ----
    rc = np.full(E, m, np.int64)
    for _ in range(num_redundant - E * (m - 1)):
        per = h / rc
        if m > 1:                            # hard floor: no co-hosting ever
            per = np.where(rc >= len(alive), -np.inf, per)
        e = int(np.argmax(per))              # argmax: first index on ties
        rc[e] += 1

    # ---- domain spread target + per-domain capacities ----
    dom_caps = None
    if domains is not None:
        dom_caps = {d: S * len([r for r in alive
                                if domains.domain_of[r] == d])
                    for d in domains.live_domains(alive)}
    span_req = required_domain_span(E, m, alive, domains, dom_caps, warn=True)

    # ---- LPT packing under the constraints ----
    items = sorted(
        ((h[e] / rc[e], e) for e in range(E) for _ in range(rc[e])),
        key=lambda t: (-t[0], t[1]))
    loads = np.zeros(num_ranks, np.float64)
    rows: dict[int, list[int]] = {r: [] for r in alive}
    hosted: dict[int, set[int]] = {r: set() for r in alive}
    placed = np.zeros(E, np.int64)
    doms_used: dict[int, set[int]] = {e: set() for e in range(E)}

    def _place(e, r, load):
        rows[r].append(e)
        hosted[r].add(e)
        loads[r] += load
        placed[e] += 1
        if domains is not None:
            doms_used[e].add(domains.domain_of[r])

    def _repair(e, want_fresh_domain: bool):
        """Free a slot on a constraint-satisfying rank by relocating one
        already-placed replica (deterministic search; returns the freed
        rank or None). Only reached under the floor when greedy order
        painted itself into a corner — the relocated replica keeps its own
        rank-distinctness and domain span."""
        targets = [r for r in alive if e not in hosted[r]]
        if want_fresh_domain:
            targets = [r for r in targets
                       if domains.domain_of[r] not in doms_used[e]]
        for r_t in sorted(targets, key=lambda r: (loads[r], r)):
            for e2 in list(rows[r_t]):
                for r_o in sorted(alive, key=lambda r: (loads[r], r)):
                    if (r_o == r_t or len(rows[r_o]) >= S
                            or e2 in hosted[r_o]):
                        continue
                    if domains is not None:
                        new_doms = {domains.domain_of[r] for r in alive
                                    if e2 in hosted[r] and r != r_t}
                        new_doms.add(domains.domain_of[r_o])
                        need2 = min(span_req, int(placed[e2]))
                        if len(new_doms) < need2:
                            continue
                    # move e2: r_t -> r_o (its load share moves with it)
                    l2 = h[e2] / rc[e2]
                    rows[r_t].remove(e2)
                    hosted[r_t].discard(e2)
                    loads[r_t] -= l2
                    rows[r_o].append(e2)
                    hosted[r_o].add(e2)
                    loads[r_o] += l2
                    if domains is not None:
                        doms_used[e2] = {domains.domain_of[r] for r in alive
                                         if e2 in hosted[r]}
                    return r_t
        return None

    for load, e in items:
        cand = [r for r in alive
                if len(rows[r]) < S and e not in hosted[r]]
        want_fresh = (domains is not None and m > 1
                      and placed[e] < span_req
                      and len(doms_used[e]) < span_req)
        if want_fresh:
            fresh = [r for r in cand
                     if domains.domain_of[r] not in doms_used[e]]
            if not fresh:
                freed = _repair(e, want_fresh_domain=True)
                if freed is None:
                    raise ValueError(
                        f"min_replicas={m} floor infeasible: expert {e} "
                        f"cannot reach {span_req} distinct fault domains "
                        f"{ctx}")
                fresh = [freed]
            cand = fresh
        elif domains is not None and cand:
            pref = [r for r in cand
                    if domains.domain_of[r] not in doms_used[e]]
            if pref:                         # soft: spread extras too
                cand = pref
        if not cand:
            if m > 1:                        # hard error under the floor
                freed = _repair(e, want_fresh_domain=False)
                if freed is None:
                    raise ValueError(
                        f"min_replicas={m} floor infeasible: no rank can "
                        f"host a distinct replica of expert {e} {ctx}")
                cand = [freed]
            else:                            # legacy: forced co-host, LOUD
                cand = [r for r in alive if len(rows[r]) < S]
                _warn_degraded(
                    f"rebalance forced to collocate replicas of expert {e} "
                    f"on one rank (every alive rank with free slots already "
                    f"hosts it) — the co-hosted replica splits no load and "
                    f"survives no rank death {ctx}")
        r = min(cand, key=lambda r: (loads[r], r))
        _place(e, r, load)
    pl = EpPlacement(E, tuple(
        tuple(rows[r]) if r in rows else (EMPTY,) * S
        for r in range(num_ranks)), version=version)
    if m > 1:
        validate_floor(pl, m, domains)       # bug guard: never emit a
        #                                      floor-violating table
        if check_shrink is None:
            check_shrink = True
        if check_shrink:
            assert_shrink_feasible(
                E, num_redundant, num_ranks, alive_ranks=alive,
                domains=domains, min_replicas=m,
                max_slots_per_rank=max_slots_per_rank, placement=pl)
    return pl


def redundant_placement(num_experts: int, num_ranks: int, num_redundant: int,
                        version: int = 0) -> EpPlacement:
    """Uniform-heat convenience: replicate ``num_redundant`` experts (ties
    resolve to the lowest ids) and pack — the zero-knowledge starting point
    before any heat has been observed."""
    return rebalance(np.ones(num_experts), num_ranks,
                     num_redundant=num_redundant, version=version)


# --------------------------------------------------------------------------
# elastic EP: degraded placements around dead ranks (docs/DESIGN.md §9)
# --------------------------------------------------------------------------

def fit_redundant(num_experts: int, num_redundant: int, n_alive: int, *,
                  min_replicas: int = 1) -> int:
    """Largest redundancy budget <= ``num_redundant`` whose total slot count
    divides by the survivor count — or, when none exists (e.g. E=8 on 7
    survivors with R=0), the smallest larger one. Keeps shrink/expand from
    failing on divisibility when the rank count changes under a fixed R.

    ``min_replicas`` imposes the replica floor on the budget itself: the
    result never drops below ``E * (min_replicas - 1)`` (each expert's floor
    replicas beyond the first consume one redundant slot), so a refit after
    rank death cannot silently fit a budget the floor can't live in —
    e.g. ``fit_redundant(8, 8, 7, min_replicas=2)`` is 13, not 6."""
    floor = num_experts * (max(min_replicas, 1) - 1)
    for r in range(num_redundant, floor - 1, -1):
        if (num_experts + r) % n_alive == 0:
            return r
    r = max(num_redundant + 1, floor)
    while (num_experts + r) % n_alive:
        r += 1
    return r


def validate_floor(placement: EpPlacement, min_replicas: int,
                   domains: FaultDomains | None = None, *,
                   where: str = "placement") -> None:
    """Assert the min-replica floor on a CONCRETE table: every expert has
    >= ``min_replicas`` replicas, each on a distinct alive rank, spanning
    >= ``required_domain_span(...)`` distinct fault domains. Raises
    ``ValueError`` naming the first offending expert — the safety net behind
    ``rebalance``'s constructive guarantees and the adoption-time check in
    the serving layer."""
    if min_replicas <= 1 and domains is None:
        return
    E = placement.num_experts
    alive = placement.alive_ranks()
    span_req = 1
    if domains is not None:
        if domains.num_ranks != placement.num_ranks:
            raise ValueError(
                f"domains cover {domains.num_ranks} ranks, {where} spans "
                f"{placement.num_ranks}")
        S = placement.slots_per_rank
        caps = {d: S * len([r for r in alive
                            if domains.domain_of[r] == d])
                for d in domains.live_domains(alive)}
        span_req = required_domain_span(E, min_replicas, alive, domains, caps)
    hosts: dict[int, list[int]] = {e: [] for e in range(E)}
    for r, row in enumerate(placement.slot_expert):
        for e in row:
            if e != EMPTY:
                hosts[e].append(r)
    for e in range(E):
        rs = hosts[e]
        if len(set(rs)) < len(rs):
            dup = sorted({r for r in rs if rs.count(r) > 1})
            raise ValueError(
                f"{where} violates the min-replica floor: expert {e} has "
                f"co-hosted replicas on rank(s) {dup} — collocated replicas "
                "split no load and survive no rank death")
        if len(rs) < min_replicas:
            raise ValueError(
                f"{where} violates the min-replica floor: expert {e} has "
                f"{len(rs)} replica(s) on ranks {sorted(rs)}, needs "
                f">= {min_replicas}")
        if domains is not None:
            span = len({domains.domain_of[r] for r in rs})
            if span < span_req:
                raise ValueError(
                    f"{where} violates the fault-domain floor: expert {e}'s "
                    f"replicas on ranks {sorted(rs)} span {span} domain(s) "
                    f"of required {span_req} (domains {domains.describe()})")


def shrink_feasibility(num_experts: int, num_redundant: int, num_ranks: int,
                       *, alive_ranks=None,
                       domains: FaultDomains | None = None,
                       min_replicas: int = 1,
                       max_slots_per_rank: int | None = None,
                       placement: EpPlacement | None = None) -> list[str]:
    """What-if every single correlated failure, BEFORE adopting a placement:
    for each failure unit (a live fault domain, or each alive rank when
    ``domains`` is None), would the shrink onto the survivors still work?
    Returns a list of human-readable infeasibility reasons (empty = all
    scenarios recoverable). A scenario is feasible when

    - the concrete ``placement`` (if given) keeps a surviving replica of
      every expert (``lost_experts`` empty) — zero-data-loss masked rebind;
    - the refitted budget ``fit_redundant(E, R, n_surv,
      min_replicas=min(m, n_surv))`` packs at <= ``num_experts`` slots per
      survivor (pigeonhole: no forced co-hosting) and at
      <= ``max_slots_per_rank`` when a headroom cap is set.

    Scenarios that kill EVERY alive rank are skipped — nothing recovers
    from losing the whole deployment, and requiring it would make every
    single-domain topology infeasible by definition."""
    alive = (tuple(range(num_ranks)) if alive_ranks is None
             else tuple(sorted(set(alive_ranks))))
    units: list[tuple[str, tuple[int, ...]]] = (
        [(f"domain {d}", tuple(r for r in domains.ranks_in(d) if r in alive))
         for d in domains.live_domains(alive)]
        if domains is not None else
        [(f"rank {r}", (r,)) for r in alive])
    problems: list[str] = []
    ctx = _floor_ctx(num_experts, num_redundant, num_ranks, alive, domains,
                     min_replicas)
    for name, killed in units:
        survivors = tuple(r for r in alive if r not in set(killed))
        if not survivors:
            continue                         # total loss: out of scope
        if placement is not None:
            lost = lost_experts(placement, survivors)
            if lost:
                problems.append(
                    f"killing {name} (ranks {list(killed)}) loses every "
                    f"replica of experts {list(lost)[:8]} — shrink would "
                    f"need a checkpoint restore {ctx}")
                continue
        m_eff = min(min_replicas, len(survivors))
        R2 = fit_redundant(num_experts, num_redundant, len(survivors),
                           min_replicas=m_eff)
        S2 = (num_experts + R2) // len(survivors)
        if S2 > num_experts:
            problems.append(
                f"killing {name} (ranks {list(killed)}) over-packs the "
                f"{len(survivors)} survivor(s): {S2} slots per rank exceed "
                f"the {num_experts} experts {ctx}")
        elif max_slots_per_rank is not None and S2 > max_slots_per_rank:
            problems.append(
                f"killing {name} (ranks {list(killed)}) over-packs the "
                f"{len(survivors)} survivor(s): {S2} slots per rank exceed "
                f"the max_slots_per_rank={max_slots_per_rank} headroom cap "
                f"{ctx}")
    return problems


def assert_shrink_feasible(num_experts: int, num_redundant: int,
                           num_ranks: int, *, alive_ranks=None,
                           domains: FaultDomains | None = None,
                           min_replicas: int = 1,
                           max_slots_per_rank: int | None = None,
                           placement: EpPlacement | None = None) -> None:
    """Raise ``ValueError`` listing every infeasible correlated-failure
    scenario found by ``shrink_feasibility`` — the adoption-time gate:
    infeasibility surfaces when a placement is BUILT, never mid-recovery."""
    problems = shrink_feasibility(
        num_experts, num_redundant, num_ranks, alive_ranks=alive_ranks,
        domains=domains, min_replicas=min_replicas,
        max_slots_per_rank=max_slots_per_rank, placement=placement)
    if problems:
        raise ValueError(
            "placement fails the shrink-feasibility precheck:\n  - "
            + "\n  - ".join(problems))


def lost_experts(placement: EpPlacement | None,
                 alive_ranks) -> tuple[int, ...]:
    """Experts whose EVERY replica sits on a non-alive rank — the weights a
    shrink cannot recover from survivors (zero-data-loss fails; the driver
    must fall back to checkpoint restore). ``placement=None`` = contiguous
    striping, where no expert has a second replica."""
    alive = set(alive_ranks)
    if placement is None:
        return ()               # resolved by the caller via identity_placement
    lost = []
    tb = tables(placement)
    for e in range(placement.num_experts):
        n = int(tb.replica_count[e])
        if not any(int(tb.replica_rank[e, j]) in alive for j in range(n)):
            lost.append(e)
    return tuple(lost)


def mask_placement(placement: EpPlacement,
                   alive_ranks) -> EpPlacement:
    """The placement restricted to its survivors: non-alive rows become all
    ``EMPTY``. This is the SOURCE layout for a zero-data-loss shrink rebind
    — collapsing through it reads only live replicas, never a dead rank's
    slots. Raises when any expert would lose its last replica
    (``lost_experts`` names them); callers check first and take the
    checkpoint-restore fallback instead."""
    alive = set(alive_ranks)
    lost = lost_experts(placement, alive)
    if lost:
        raise ValueError(
            f"experts {list(lost)[:8]} have no replica on alive ranks "
            f"{sorted(alive)} — weights unrecoverable from survivors "
            "(restore from checkpoint)")
    S = placement.slots_per_rank
    tbl = tuple(row if r in alive else (EMPTY,) * S
                for r, row in enumerate(placement.slot_expert))
    if tbl == placement.slot_expert:
        return placement
    return dataclasses.replace(placement, slot_expert=tbl)


def _floor_kwargs(min_replicas: int, domains: FaultDomains | None,
                  max_slots_per_rank: int | None, *,
                  check_shrink: bool | None = None) -> dict:
    """The kwargs the elastic paths forward to ``rebalance`` — EMPTY unless
    floor mode is active (``min_replicas > 1`` or explicit ``domains``), so
    a legacy custom ``rebalance_fn`` that predates the floor keeps working
    and legacy placements stay bit-identical."""
    if min_replicas <= 1 and domains is None:
        return {}
    kw: dict = dict(min_replicas=min_replicas, domains=domains,
                    max_slots_per_rank=max_slots_per_rank)
    if check_shrink is not None:
        kw["check_shrink"] = check_shrink
    return kw


def shrink_placement(heat, num_ranks: int, dead_ranks, *,
                     num_redundant: int = 0, version: int = 1,
                     rebalance_fn=None, min_replicas: int = 1,
                     domains: FaultDomains | None = None,
                     max_slots_per_rank: int | None = None) -> EpPlacement:
    """Degraded placement after rank death: every expert packed onto the
    survivors (dead rows all ``EMPTY`` — zero slots, zero traffic), the
    redundancy budget auto-fitted to the survivor count. Heat-driven like
    any rebalance, so the degraded table is still load-balanced.

    Under the min-replica floor the budget refit keeps the floor's share
    (``fit_redundant(..., min_replicas=...)``, the floor itself relaxing to
    the survivor count when fewer ranks than ``min_replicas`` remain) and
    the repack enforces distinct ranks/domains — but the degraded table
    skips the what-if shrink precheck: the HEALTHY placement's
    adoption-time precheck already guaranteed this shrink works, and
    demanding the degraded table survive a FURTHER correlated failure
    would turn every recovery into a double-failure requirement."""
    dead = set(dead_ranks)
    alive = tuple(r for r in range(num_ranks) if r not in dead)
    if not alive:
        raise ValueError(f"all {num_ranks} ranks dead — nothing to shrink onto")
    E = np.asarray(heat).size
    m_eff = min(min_replicas, len(alive))
    R = fit_redundant(E, num_redundant, len(alive), min_replicas=m_eff)
    fn = rebalance_fn or rebalance
    return fn(heat, num_ranks, num_redundant=R, version=version,
              alive_ranks=alive,
              **_floor_kwargs(m_eff, domains, max_slots_per_rank,
                              check_shrink=False))


def expand_placement(heat, num_ranks: int, *, num_redundant: int = 0,
                     version: int = 1, rebalance_fn=None,
                     min_replicas: int = 1,
                     domains: FaultDomains | None = None,
                     max_slots_per_rank: int | None = None) -> EpPlacement:
    """The symmetric rejoin path: a full-width rebalance over all ranks
    again (redundancy budget refitted in case the caller's R only fit the
    degraded geometry). The rejoined rank's slots are filled by replica
    expansion at adoption — replicas duplicate live weights, so re-expand
    is always zero-data-loss. Floor mode re-runs the full shrink-
    feasibility precheck: a full-width table must again survive any single
    correlated failure."""
    E = np.asarray(heat).size
    R = fit_redundant(E, num_redundant, num_ranks, min_replicas=min_replicas)
    fn = rebalance_fn or rebalance
    return fn(heat, num_ranks, num_redundant=R, version=version,
              **_floor_kwargs(min_replicas, domains, max_slots_per_rank))


class RebalanceScheduler:
    """Host-side EPLB schedule shared by the runtime drivers
    (`runtime/decode.py`, `runtime/prefill.py`, `runtime/server.py`):
    ``observe`` folds heat, ``advance`` emits the placement for the next
    window. When the rebalancer reproduces the current slot table verbatim
    (steady traffic), the SAME placement object is returned — version and
    fingerprint unchanged — so per-placement compiled-function caches keep
    hitting and the refresh fast path survives the boundary.

    Elastic EP: ``set_alive`` narrows the scheduler to the surviving ranks —
    every subsequent ``advance`` emits a DEGRADED placement (dead rows all
    ``EMPTY``, redundancy refitted to the survivor count); restoring the
    full set flips it back to full-width tables (the rejoin/expand path).
    A custom ``rebalance_fn`` must accept ``alive_ranks=`` to be used with
    a narrowed alive set (and the floor kwargs when ``min_replicas``/
    ``domains`` are set — floor kwargs are only forwarded in floor mode,
    so legacy custom fns keep working floor-less).

    Fault-domain floor (docs/DESIGN.md §9): with ``min_replicas > 1``
    and/or ``domains``, every emitted FULL-WIDTH placement enforces the
    floor and passes the shrink-feasibility precheck before it leaves the
    scheduler; degraded placements enforce the (survivor-relaxed) floor
    but skip the what-if precheck."""

    def __init__(self, num_experts: int, num_ranks: int, *,
                 num_redundant: int = 0, decay: float = 0.0,
                 rebalance_fn=None, initial: EpPlacement | None = None,
                 min_replicas: int = 1,
                 domains: FaultDomains | None = None,
                 max_slots_per_rank: int | None = None):
        if min_replicas < 1:
            raise ValueError(f"min_replicas={min_replicas} must be >= 1")
        if domains is not None and domains.num_ranks != num_ranks:
            raise ValueError(f"domains cover {domains.num_ranks} ranks, "
                             f"scheduler spans num_ranks={num_ranks}")
        self.tracker = HeatTracker(num_experts, decay=decay)
        self.num_ranks = num_ranks
        self.num_redundant = num_redundant
        self.rebalance_fn = rebalance_fn or rebalance
        self.placement = initial
        self.alive: tuple[int, ...] = tuple(range(num_ranks))
        self._version = 0
        self.min_replicas = min_replicas
        self.domains = domains
        self.max_slots_per_rank = max_slots_per_rank

    def observe(self, heat):
        self.tracker.update(heat)

    def set_alive(self, alive_ranks):
        alive = tuple(sorted(set(alive_ranks)))
        if not alive or any(not 0 <= r < self.num_ranks for r in alive):
            raise ValueError(f"alive_ranks={alive_ranks} must be a non-empty "
                             f"subset of range({self.num_ranks})")
        self.alive = alive

    def advance(self) -> EpPlacement:
        v = self._version + 1
        if len(self.alive) < self.num_ranks:
            dead = [r for r in range(self.num_ranks) if r not in self.alive]
            new = shrink_placement(self.tracker.totals, self.num_ranks, dead,
                                   num_redundant=self.num_redundant,
                                   version=v, rebalance_fn=self.rebalance_fn,
                                   min_replicas=self.min_replicas,
                                   domains=self.domains,
                                   max_slots_per_rank=self.max_slots_per_rank)
        else:
            R = fit_redundant(self.tracker.totals.size, self.num_redundant,
                              self.num_ranks,
                              min_replicas=self.min_replicas)
            new = self.rebalance_fn(self.tracker.totals, self.num_ranks,
                                    num_redundant=R, version=v,
                                    **_floor_kwargs(self.min_replicas,
                                                    self.domains,
                                                    self.max_slots_per_rank))
        if (self.placement is not None
                and new.slot_expert == self.placement.slot_expert):
            return self.placement            # unchanged table: reuse object
        self._version += 1
        self.placement = (new if new.version == self._version
                          else dataclasses.replace(new, version=self._version))
        return self.placement


def run_rebalancing(base_cfg, make_fn, items, *, advance_every: int,
                    ep_size: int, comm=None, num_redundant: int = 0,
                    inner_size: int | None = None, decay: float = 0.0,
                    rebalance_fn=None, params=None,
                    expert_keys: tuple = EXPERT_PARAM_KEYS,
                    donate_params: bool = True, fault_injector=None,
                    min_replicas: int = 1,
                    fault_domains: FaultDomains | None = None,
                    max_slots_per_rank: int | None = None,
                    tracer=None, series=None):
    """Shared skeleton of the host-level EPLB drivers (`runtime/decode.py`,
    `runtime/prefill.py`): run each item through a per-placement fn, fold
    its heat, and advance the placement at every ``advance_every`` item
    boundary (never after the last item). ``make_fn(group)`` builds the
    caller's unit returning ``(out, heat)``, on a group over ``comm`` (the
    port's EP API exchanges through it; None builds a group for capacity
    arithmetic alone); fns are cached per placement object, so an unchanged
    rebalance table (the scheduler's dedup) rebuilds nothing. The cache is
    bounded to the current and previous placement. Returns ``(outs,
    placements)``, one entry per item.

    Adopt-once physical weights: with ``params`` (a dict tree whose
    ``expert_keys`` leaves carry a leading expert axis), ``make_fn`` is
    called as ``make_fn(group, params)`` where the expert leaves have been
    rebound once per adopted placement into that placement's physical slot
    order (old physical -> new physical), so no step expands them
    (docs/DESIGN.md §8). ``params`` must arrive laid out for
    ``base_cfg.placement`` (logical when that is None). With
    ``donate_params=True`` (default) the driver takes ownership: the tree
    is rebound in place at each boundary (peak memory about one weight
    set plus one leaf), so the caller's tensors change; pass
    ``donate_params=False`` to keep the original tree.

    Elastic EP (``fault_injector``) is not ported yet: passing one raises
    ``NotImplementedError`` (ROADMAP A10b).

    Fault-domain floor (``min_replicas`` / ``fault_domains`` /
    ``max_slots_per_rank``, docs/DESIGN.md §9): forwarded to the scheduler —
    every adopted full-width placement then satisfies the floor and the
    shrink-feasibility precheck.

    Telemetry (``tracer`` / ``series``, runtime/telemetry.py): each advance
    boundary lands as a ``rebalance`` span (params rebind nested as
    ``adopt``), injected faults as instants, and — with ``series`` — a
    per-window row carrying the imbalance ratio under the placement the
    window RAN under vs under the newly adopted one. Host-side only: the
    heat is already on the host at every boundary."""
    from repro_torch.checkpoint.store import rebind_expert_leaves
    from repro_torch.core.group import ep_create_group

    if fault_injector is not None:
        raise NotImplementedError("run_rebalancing's fault path (rank death, "
                                  "shrink and expand) is not ported yet "
                                  "(ROADMAP A10b)")
    if advance_every < 1:
        raise ValueError(f"rebalance_every={advance_every} must be >= 1")
    sched = RebalanceScheduler(
        base_cfg.num_experts, ep_size, num_redundant=num_redundant,
        decay=decay, rebalance_fn=rebalance_fn, initial=base_cfg.placement,
        min_replicas=min_replicas, domains=fault_domains,
        max_slots_per_rank=max_slots_per_rank)
    pl = base_cfg.placement
    fns: dict = {}
    outs, placements = [], []
    for i, item in enumerate(items):
        cfg = dataclasses.replace(base_cfg, placement=pl, num_redundant_experts=0)
        group = ep_create_group(cfg, comm, ep_size=ep_size, inner_size=inner_size)
        if pl not in fns:
            fns[pl] = (make_fn(group) if params is None
                       else make_fn(group, params))
            if len(fns) > 2:     # keep current + previous placement only
                for k in [k for k in fns if k is not pl][:-1]:
                    del fns[k]
        out, heat = fns[pl](item)
        outs.append(out)
        placements.append(pl)
        window = host_heat(heat)
        sched.observe(window)
        if (i + 1) % advance_every == 0 and i + 1 < len(items):
            with (tracer.span("rebalance", step=i) if tracer is not None
                  else contextlib.nullcontext()):
                new_pl = sched.advance()
                if series is not None:
                    # the window's imbalance as experienced (old placement)
                    # vs what the freshly adopted table would have given it
                    series.record(
                        kind="rebalance", step=i,
                        window_tokens=float(window.sum()),
                        imbalance=imbalance(rank_loads(window, pl, ep_size)),
                        imbalance_after=imbalance(
                            rank_loads(window, new_pl, ep_size)),
                        placement_changed=new_pl is not pl)
                if new_pl is not pl and params is not None:
                    with (tracer.span("adopt", step=i) if tracer is not None
                          else contextlib.nullcontext()):
                        params = rebind_expert_leaves(
                            params, expert_keys, src_placement=pl,
                            dst_placement=new_pl, donate=donate_params)
                pl = new_pl
    return outs, placements


# --------------------------------------------------------------------------
# replica-aware expert-parameter rebinding
# --------------------------------------------------------------------------

def expand_expert_params(w, placement: EpPlacement, axis: int = 0):
    """Logical expert-stacked weights [..., E, ...] -> physical slot order
    [..., N*S, ...] along ``axis``: each physical slot gets its logical
    expert's weights (replicas duplicate). numpy stays numpy (host-side
    rebinds), a tensor is gathered on its own device (``axis`` covers
    stacked trees whose expert dim sits behind the layer axis). Empty
    (degraded) slots host nothing but still need rows: they carry expert
    0's weights, and plan-time assignment never routes a token to them."""
    if isinstance(w, np.ndarray):
        perm = tables(placement).slot_expert.reshape(-1)
        return np.take(w, np.where(perm == EMPTY, 0, perm), axis=axis)
    return torch.index_select(w, axis, device_tables(placement, w.device).slot_perm)


def collapse_expert_params(w_phys, placement: EpPlacement, axis: int = 0):
    """Physical slot-ordered weights [..., N*S, ...] -> logical [..., E, ...]
    along ``axis`` via each expert's primary replica (replicas hold identical
    weights by construction, so any replica would do; the primary is
    deterministic). numpy in, numpy out (see ``expand_expert_params``)."""
    if isinstance(w_phys, np.ndarray):
        return np.take(w_phys, tables(placement).primary_row, axis=axis)
    return torch.index_select(w_phys, axis,
                              device_tables(placement, w_phys.device).primary_row)
