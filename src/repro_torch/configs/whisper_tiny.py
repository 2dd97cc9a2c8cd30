"""whisper-tiny [audio]: enc-dec, conv frontend stubbed (precomputed frame
embeddings via input_specs).  [arXiv:2212.04356]"""

from repro_torch.configs.base import ModelConfig, register


@register("whisper-tiny")
def whisper_tiny() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny",
        family="encdec",
        n_layers=4,                # decoder layers
        d_model=384,
        n_heads=6,
        n_kv_heads=6,
        d_ff=1536,
        vocab=51_865,
        enc_layers=4,
        enc_seq=1500,              # 30s audio → 1500 frames after conv stub
        frontend="audio",
        rope_fraction=0.0,         # whisper uses learned/sinusoidal positions
        sub_quadratic=False,
    )
