"""Architecture configs: one module per ported architecture."""
from repro_torch.configs.base import ArchConfig, MoEConfig, MambaConfig, MLAConfig  # noqa: F401
from repro_torch.configs.registry import get_config, list_archs  # noqa: F401
