"""repro_torch.core: the unified EP API over a communicator (LL mode in the
``nccl_ep`` layout, HT mode on its flat path)."""
from repro_torch.core.api import (  # noqa: F401
    EpGroup, EpGroupConfig, EpHandle, EpPending, ep_combine, ep_complete,
    ep_create_group, ep_create_handle, ep_dispatch,
)
from repro_torch.core.routing import RouterConfig, RouterOutput, route  # noqa: F401
