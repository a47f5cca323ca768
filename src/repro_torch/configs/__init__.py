from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      get_config, get_smoke_config,
                                      list_archs, supported_shapes)
