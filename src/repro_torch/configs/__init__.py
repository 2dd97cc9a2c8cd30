from repro_torch.configs.base import (SHAPES, HybridCfg, MatmulRole,
                                      ModelConfig, MoECfg, ShapeCfg, SSMCfg,
                                      get_config, list_archs)

__all__ = ["HybridCfg", "MatmulRole", "ModelConfig", "MoECfg", "SHAPES",
           "SSMCfg", "ShapeCfg", "get_config", "list_archs"]
