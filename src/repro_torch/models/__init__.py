"""Model families (dense decoder) and the model zoo."""
from repro_torch.models.model_zoo import Model, build_model, resolve_attn_mode  # noqa: F401
