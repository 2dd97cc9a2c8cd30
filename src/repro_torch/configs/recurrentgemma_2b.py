"""recurrentgemma-2b [hybrid]: RG-LRU + local attention, 1 attn : 2 recurrent.
26 = 8×(rec, rec, attn) + 2 rec.  [arXiv:2402.19427]"""

from repro_torch.configs.base import HybridCfg, ModelConfig, register


@register("recurrentgemma-2b")
def recurrentgemma_2b() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        d_ff=7680,
        vocab=256_000,
        hybrid=HybridCfg(block=("rec", "rec", "attn"), tail=("rec", "rec")),
        window=2048,               # local attention window
        sub_quadratic=True,
    )
