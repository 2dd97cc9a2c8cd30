from repro_torch.configs.base import MatmulRole, ModelConfig, get_config

__all__ = ["MatmulRole", "ModelConfig", "get_config"]
