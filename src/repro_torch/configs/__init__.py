"""Registered architecture configs (one module per arch) + the paper's app.

Counterpart of ``repro.configs``: importing this package registers
minitron-8b, internlm2-20b, qwen1.5-32b (QKV bias), gemma3-27b (5:1
local:global attention), the MoE configs kimi-k2-1t-a32b and
llama4-maverick-400b-a17b (``lm``), paligemma-3b (``vlm``),
whisper-large-v3 (``encdec``), xlstm-125m (``xlstm``), zamba2-1.2b
(``zamba``) and edge-detect with :mod:`repro_torch.models.registry`.
"""
from repro_torch.configs import (  # noqa: F401
    edge_detect,
    gemma3_27b,
    internlm2_20b,
    kimi_k2_1t_a32b,
    llama4_maverick_400b_a17b,
    minitron_8b,
    paligemma_3b,
    qwen1_5_32b,
    whisper_large_v3,
    xlstm_125m,
    zamba2_1_2b,
)
