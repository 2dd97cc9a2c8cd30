"""gemma3-27b [dense]: 5:1 local:global attention, 128k context.
62 = 10×(5 local + 1 global) + 2 local.  [hf:google/gemma-3]"""

from repro_torch.configs.base import HybridCfg, ModelConfig, register


@register("gemma3-27b")
def gemma3_27b() -> ModelConfig:
    return ModelConfig(
        name="gemma3-27b",
        family="dense",
        n_layers=62,
        d_model=5376,
        n_heads=32,
        n_kv_heads=16,
        d_ff=21_504,
        vocab=262_144,
        d_head=128,
        hybrid=HybridCfg(block=("local",) * 5 + ("global",),
                         tail=("local", "local")),
        window=1024,               # sliding window for local layers
        rope_base=1_000_000.0,
        sparse_ffn=True,
        # local-attention-dominant: long_500k runs (global layers hold
        # full-length KV; decode is linear in S) — DESIGN.md §5
        sub_quadratic=True,
    )
