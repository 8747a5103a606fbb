"""Models of the port: the paper's linear regression and CNN, and the
DENSE, MOE and HYBRID transformers of the LLM zoo."""
from repro_torch.models.api import Model, build_model  # noqa: F401
