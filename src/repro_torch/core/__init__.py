"""SQuant core: the paper's contribution as composable PyTorch functions."""
from repro_torch.core.squant import SQuantConfig, squant, squant_codes  # noqa: F401
from repro_torch.core.pipeline import quantize_tree, QuantReport  # noqa: F401
from repro_torch.core.dispatch import BACKENDS, resolve_backend  # noqa: F401
