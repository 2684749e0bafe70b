"""repro_torch.core: the unified EP API over a communicator (LL mode,
``nccl_ep`` layout in this slice)."""
from repro_torch.core.api import (  # noqa: F401
    EpGroup, EpGroupConfig, EpHandle, EpPending, ep_combine, ep_complete,
    ep_create_group, ep_create_handle, ep_dispatch,
)
from repro_torch.core.routing import RouterConfig, RouterOutput, route  # noqa: F401
