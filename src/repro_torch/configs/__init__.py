from repro_torch.configs.base import (ASSIGNED_ARCHS, LM_SHAPES,  # noqa: F401
                                      PAPER_ARCHS, SMOKE_SHAPE, AttnConfig,
                                      ModelConfig, MoEConfig, ShapeConfig,
                                      SSMConfig, get_config, list_archs,
                                      reduced, register, shape_applicable)
from repro_torch.configs import archs  # noqa: F401  — populates the registry
