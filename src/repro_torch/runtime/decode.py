"""Double-buffered EP decode (port of ``naive_decode_step``,
``_staged_pair``, ``pipelined_decode_step`` and ``decode_loop`` in
``src/repro/runtime/decode.py``): the paper's §IV overlap as a decode loop.

A decode step's tokens are cut into a micro-batch pair (the two buffers).
``_staged_pair`` starts both dispatch sends before completing the first, so
B's all-to-all can overlap A's unpack and expert GEMMs, and A's combine send
before B's experts run, so A's all-to-all can overlap B's GEMMs. On the
card, A's chain runs on one CUDA stream and B's on another: both fork from
the current stream and join back to it at the end of the pair, so the card
can run the two chains at once; a fork and join across streams is legal
inside a CUDA graph capture, so a steady-state step can be captured. On the
CPU the same order runs on one stream.

Steady state is plan-free: after step 0, handles are refreshed with
``ep_handle_refresh`` (the routing-hash select of ``plan.refresh_handle``)
instead of rebuilt. The loop is mode-agnostic: the staged surface is part
of every backend's contract. As everywhere in the port's EP API, a value per
hosted rank is a list indexed like ``group.comm.ranks``; ``router_fn`` and
``expert_fn`` are those of ``runtime/prefill.py``. ``rebalancing_decode_loop``
swaps EPLB placements between windows of steps (``placement.run_rebalancing``).
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import ep_combine, ep_complete, ep_dispatch, ep_handle_refresh
from repro_torch.core import placement as PL
from repro_torch.core.group import EpGroup, EpGroupConfig
from repro_torch.runtime.prefill import ExpertFn, RouterFn, _experts, _handle

# the two streams of each card's micro-batch chains, made at first use and
# kept: B3's split-tile counters are per stream, and a capture replays the
# streams its warm-up ran on
_STREAMS: dict[int, tuple[torch.cuda.Stream, torch.cuda.Stream]] = {}


def _chain_streams(dev: torch.device):
    pair = _STREAMS.get(dev.index)
    if pair is None:
        pair = (torch.cuda.Stream(dev), torch.cuda.Stream(dev))
        _STREAMS[dev.index] = pair
    return pair


def naive_decode_step(group: EpGroup, router_fn: RouterFn, expert_fn: ExpertFn,
                      xs: list) -> list:
    """The unpipelined per-step baseline: build the handles (the full plan)
    and run dispatch, experts and combine in turn. xs: [T, H] per hosted
    rank -> the combined [T, H] per hosted rank."""
    h = _handle(group, router_fn, xs)
    return ep_combine(group, h, _experts(group, expert_fn, ep_dispatch(group, h, xs)))


def _staged_pair(group: EpGroup, expert_fn: ExpertFn, ha: list, hb: list,
                 xa: list, xb: list):
    """The double-buffer schedule over one micro-batch pair. Returns
    (out_a, out_b), each a list over the hosted ranks."""
    dev = xa[0].device
    cur = sa = sb = None            # on the CPU torch.cuda.stream(None) is a no-op
    if dev.type == "cuda":
        cur = torch.cuda.current_stream(dev)
        sa, sb = _chain_streams(dev)
        sa.wait_stream(cur)
        sb.wait_stream(cur)
    with torch.cuda.stream(sa):
        pa = ep_dispatch(group, ha, xa, send_only=True)
    with torch.cuda.stream(sb):
        pb = ep_dispatch(group, hb, xb, send_only=True)       # B's a2a in flight
    with torch.cuda.stream(sa):
        qa = ep_combine(group, ha, _experts(group, expert_fn, ep_complete(group, ha, pa)),
                        send_only=True)
    with torch.cuda.stream(sb):                               # over A's combine a2a
        qb = ep_combine(group, hb, _experts(group, expert_fn, ep_complete(group, hb, pb)),
                        send_only=True)
    with torch.cuda.stream(sa):
        oa = ep_complete(group, ha, qa)
    with torch.cuda.stream(sb):
        ob = ep_complete(group, hb, qb)
    if cur is not None:
        cur.wait_stream(sa)
        cur.wait_stream(sb)
        for o in oa + ob:           # made on a chain's stream, used on this one
            o.record_stream(cur)
    return oa, ob


def pipelined_decode_step(group: EpGroup, router_fn: RouterFn, expert_fn: ExpertFn,
                          handles: Sequence[list], xa: list, xb: list):
    """One steady-state step over a micro-batch pair: both pairs' handles
    refreshed (not rebuilt), then the staged schedule. Returns ((out_a,
    out_b), (handles_a, handles_b)); feed the handles back in next step."""
    ra = [router_fn(x) for x in xa]
    rb = [router_fn(x) for x in xb]
    ha = ep_handle_refresh(group, handles[0], [r[1] for r in ra], [r[0] for r in ra])
    hb = ep_handle_refresh(group, handles[1], [r[1] for r in rb], [r[0] for r in rb])
    return _staged_pair(group, expert_fn, ha, hb, xa, xb), (ha, hb)


def decode_loop(group: EpGroup, router_fn: RouterFn, expert_fn: ExpertFn,
                xs: Sequence[tuple[list, list]]):
    """Drive a sequence of micro-batch pairs, one (xa, xb) per decode step,
    through the pipeline. Step 0 creates the two pairs' handles (the only
    full plan construction in the window); every later step refreshes them.
    Returns [(out_a, out_b)] per step."""
    outs = []
    handles = None
    for xa, xb in xs:
        if handles is None:
            handles = (_handle(group, router_fn, xa), _handle(group, router_fn, xb))
            outs.append(_staged_pair(group, expert_fn, handles[0], handles[1], xa, xb))
            continue
        pair, handles = pipelined_decode_step(group, router_fn, expert_fn, handles,
                                              xa, xb)
        outs.append(pair)
    return outs


def rebalancing_decode_loop(base_cfg: EpGroupConfig, make_window, xs, *,
                            rebalance_every: int, ep_size: int, comm=None,
                            num_redundant: int = 0, inner_size: int | None = None,
                            decay: float = 0.0, rebalance_fn=PL.rebalance,
                            params=None, expert_keys: tuple = PL.EXPERT_PARAM_KEYS,
                            donate_params: bool = True, fault_injector=None,
                            min_replicas: int = 1, fault_domains=None,
                            max_slots_per_rank: int | None = None):
    """Host-level EPLB decode driver: placements swap between steps, at
    window boundaries. ``make_window(group) -> fn(steps) -> (outs, heat)``
    runs a window of steps (typically ``decode_loop`` plus a routed-token
    histogram) on a group over ``comm`` built for the window's placement;
    every ``rebalance_every`` steps the folded heat drives the rebalancer
    and the next window runs under the new table. Windows are cached per
    placement (an unchanged table reuses its object and its window), and
    handles carried across a swap are rebuilt by the placement-salted
    routing hash. Returns ``(outs, placements)``: the per-step outputs and
    each window's placement (None = contiguous).

    Adopt-once physical weights: with ``params`` (expert-stacked leaves
    under ``expert_keys``, laid out for ``base_cfg.placement``),
    ``make_window(group, params)`` gets the leaves rebound once per adopted
    placement; the driver takes ownership unless ``donate_params=False``.
    ``fault_injector`` raises ``NotImplementedError`` (ROADMAP A10b)."""
    if rebalance_every < 1:
        raise ValueError(f"rebalance_every={rebalance_every} must be >= 1")
    windows = [xs[s:s + rebalance_every] for s in range(0, len(xs), rebalance_every)]
    win_outs, placements = PL.run_rebalancing(
        base_cfg, make_window, windows, advance_every=1, ep_size=ep_size, comm=comm,
        num_redundant=num_redundant, inner_size=inner_size, decay=decay,
        rebalance_fn=rebalance_fn, params=params, expert_keys=expert_keys,
        donate_params=donate_params, fault_injector=fault_injector,
        min_replicas=min_replicas, fault_domains=fault_domains,
        max_slots_per_rank=max_slots_per_rank)
    return [o for w in win_outs for o in w], placements
