"""repro_torch.core: the unified EP API over a communicator, in its three
modes: LL (``nccl_ep`` and ``deepep`` layouts), HT (flat, and hierarchical
with its chunk pipeline) and the baseline a2a dispatcher; with the
tagged-tensor surface."""
from repro_torch.core.api import (  # noqa: F401
    EpGroup, EpGroupConfig, EpHandle, EpPending, ep_combine, ep_combine_tensors,
    ep_complete, ep_create_group, ep_create_handle, ep_dispatch,
    ep_dispatch_tensors, ep_handle_refresh,
)
from repro_torch.core.routing import RouterConfig, RouterOutput, route  # noqa: F401
from repro_torch.core.tensor import EpTensor, EpTensorTag, ep_tensor_create  # noqa: F401
