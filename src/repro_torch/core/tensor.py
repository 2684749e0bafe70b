"""EpTensor: a tensor with a semantic tag (port of
``src/repro/core/tensor.py``).

The paper's ``ncclNDTensor_t`` (§III-E) carries shape, strides, dtype, tag
and pointer so the C library can check each argument's role and apply the
mode's transforms. A torch tensor already carries shape, strides and dtype;
what the port keeps is the tag, which lets the tagged entry points
(``core/api.py ep_dispatch_tensors`` / ``ep_combine_tensors``) check that
the right tensors were passed, as the C API does.
"""
from __future__ import annotations

import dataclasses
import enum

import torch


class EpTensorTag(enum.Enum):
    """Semantic roles, Table IV of the paper."""

    TOKENS = "tokens"                       # token data (input or output)
    TOPK_IDX = "topk_idx"                   # top-k expert indices
    TOPK_WEIGHTS = "topk_weights"           # top-k router weights
    SCALES = "scales"                       # fp8 / int8 quantization scales
    RECV_EXPERT_COUNTER = "recv_expert_counter"  # per-expert token counts
    TOKENS_PER_EXPERTS = "tokens_per_experts"    # per-expert counts (dispatch out)
    NONE = "none"


@dataclasses.dataclass
class EpTensor:
    """A tagged tensor."""

    data: torch.Tensor
    tag: EpTensorTag = EpTensorTag.NONE

    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype


def ep_tensor_create(data: torch.Tensor, tag: EpTensorTag) -> EpTensor:
    """``ncclEpTensorCreate``."""
    return EpTensor(data=data, tag=tag)


_ALLOWED_DTYPES = {
    EpTensorTag.TOKENS: (torch.float32, torch.bfloat16, torch.float16,
                         torch.float8_e4m3fn, torch.int8),
    EpTensorTag.TOPK_IDX: (torch.int32,),
    EpTensorTag.TOPK_WEIGHTS: (torch.float32, torch.bfloat16),
    EpTensorTag.SCALES: (torch.float32,),
    EpTensorTag.TOKENS_PER_EXPERTS: (torch.int32,),
    EpTensorTag.RECV_EXPERT_COUNTER: (torch.int32,),
}


def validate(t, *, tag: EpTensorTag, ndim: int | None = None) -> torch.Tensor:
    """Check a tagged tensor's role, dtype and rank; return the raw tensor.
    A raw tensor is taken as it is, like the reference's ctypes wrapper
    takes one. Raises ``ValueError``, the C API's ``ncclInvalidArgument``."""
    if isinstance(t, EpTensor):
        if t.tag != tag:
            raise ValueError(f"EpTensor tagged {t.tag} where {tag} expected")
        data = t.data
    else:
        data = t
    allowed = _ALLOWED_DTYPES.get(tag)
    if allowed is not None and data.dtype not in allowed:
        raise ValueError(f"{tag}: dtype {data.dtype} not in allowed {allowed}")
    if ndim is not None and data.dim() != ndim:
        raise ValueError(f"{tag}: expected rank {ndim}, got shape {tuple(data.shape)}")
    return data


def as_array(t) -> torch.Tensor:
    """The raw tensor of a tagged or raw tensor."""
    return t.data if isinstance(t, EpTensor) else t
