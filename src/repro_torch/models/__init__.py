"""Model layers, the LM forward and decode stacks, and the registry of the
port."""
from repro_torch.models.registry import ModelFns, get_model  # noqa: F401
