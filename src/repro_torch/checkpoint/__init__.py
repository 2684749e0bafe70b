"""Expert-weight rebinding between placements (port of the in-memory half
of ``src/repro/checkpoint/store.py``). ``save_checkpoint`` /
``restore_checkpoint`` are ROADMAP A10b."""
from repro_torch.checkpoint.store import (  # noqa: F401
    EXPERT_PARAM_KEYS, adopt_expert_params, rebind_expert_leaves,
)
