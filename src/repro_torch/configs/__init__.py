from repro_torch.configs.base import (PAPER_ARCHS, AttnConfig,  # noqa: F401
                                      ModelConfig, MoEConfig, SSMConfig,
                                      ShapeConfig, get_config, list_archs,
                                      reduced, register)
from repro_torch.configs import archs  # noqa: F401  — populates the registry
