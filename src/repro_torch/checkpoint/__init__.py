"""Expert-weight rebinding between placements and placement-tagged
checkpoints (port of ``src/repro/checkpoint/store.py``)."""
from repro_torch.checkpoint.store import (  # noqa: F401
    EXPERT_PARAM_KEYS, adopt_expert_params, latest_step, rebind_expert_leaves,
    restore_checkpoint, save_checkpoint,
)
