"""repro_torch.core: the unified EP API over a communicator, in its three
modes: LL (``nccl_ep`` and ``deepep`` layouts), HT (flat, and hierarchical
with its chunk pipeline) and the baseline a2a dispatcher; with the
tagged-tensor surface and EPLB placement (``placement``)."""
from repro_torch.core.api import (  # noqa: F401
    EpGroup, EpGroupConfig, EpHandle, EpPending, ep_combine, ep_combine_tensors,
    ep_complete, ep_create_group, ep_create_handle, ep_dispatch,
    ep_dispatch_tensors, ep_handle_destroy, ep_handle_get_num_recv_tokens,
    ep_handle_refresh, registered_modes,
)
from repro_torch.core.backend import (  # noqa: F401
    BaseBackend, get_backend, register_backend,
)
from repro_torch.core.placement import (  # noqa: F401
    EpPlacement, HeatTracker, collapse_expert_params, expand_expert_params,
    fold_slot_counts, heat_from_topk, identity_placement, imbalance,
    placement_from_jsonable, placement_to_jsonable, rank_loads, rebalance,
    redundant_placement,
)
from repro_torch.core.plan import EpPlan, build_plan, routing_hash  # noqa: F401
from repro_torch.core.routing import RouterConfig, RouterOutput, route  # noqa: F401
from repro_torch.core.tensor import EpTensor, EpTensorTag, ep_tensor_create  # noqa: F401
