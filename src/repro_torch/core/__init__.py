"""repro_torch.core: the unified EP API over a communicator, in its three
modes: LL (``nccl_ep`` and ``deepep`` layouts), HT (the flat path) and the
baseline a2a dispatcher."""
from repro_torch.core.api import (  # noqa: F401
    EpGroup, EpGroupConfig, EpHandle, EpPending, ep_combine, ep_complete,
    ep_create_group, ep_create_handle, ep_dispatch, ep_handle_refresh,
)
from repro_torch.core.routing import RouterConfig, RouterOutput, route  # noqa: F401
