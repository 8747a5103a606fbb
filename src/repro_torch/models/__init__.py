"""Models of the port (the linear regression of the paper so far)."""
from repro_torch.models.api import Model, build_model  # noqa: F401
