"""SFPrompt core, ported: the three-way split model and the serving cost
model (`serve_comm_breakdown`)."""
from repro_torch.core.split import SplitConfig, SplitModel  # noqa: F401
