"""Import all architecture configs to populate the registry."""

import repro_torch.configs.chatglm3_6b        # noqa: F401
import repro_torch.configs.deepseek_coder_33b  # noqa: F401
import repro_torch.configs.gemma3_27b         # noqa: F401
import repro_torch.configs.granite_moe_3b     # noqa: F401
import repro_torch.configs.internlm2_20b      # noqa: F401
import repro_torch.configs.mamba2_780m        # noqa: F401
import repro_torch.configs.pixtral_12b        # noqa: F401
import repro_torch.configs.qwen3_moe_30b      # noqa: F401
import repro_torch.configs.recurrentgemma_2b  # noqa: F401
import repro_torch.configs.whisper_tiny       # noqa: F401
