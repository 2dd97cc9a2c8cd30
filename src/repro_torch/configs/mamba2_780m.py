"""mamba2-780m [ssm]: SSD (state-space duality), attention-free.
[arXiv:2405.21060]"""

from repro_torch.configs.base import ModelConfig, SSMCfg, register


@register("mamba2-780m")
def mamba2_780m() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m",
        family="ssm",
        n_layers=48,
        d_model=1536,
        n_heads=0,                 # attention-free
        n_kv_heads=0,
        d_ff=0,
        vocab=50_280,
        ssm=SSMCfg(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
        sub_quadratic=True,
    )
