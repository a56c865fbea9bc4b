"""Registered architecture configs (one module per arch) + the paper's app.

Counterpart of ``repro.configs`` for the dense ``lm`` family this port
serves: importing this package registers minitron-8b, internlm2-20b,
qwen1.5-32b (QKV bias), gemma3-27b (5:1 local:global attention) and
edge-detect with :mod:`repro_torch.models.registry`. The MoE (kimi-k2,
llama4-maverick), vlm (paligemma), encdec (whisper), xlstm and zamba
configs wait for their model slices (ROADMAP.md, queue 1 item 7).
"""
from repro_torch.configs import (  # noqa: F401
    edge_detect,
    gemma3_27b,
    internlm2_20b,
    minitron_8b,
    qwen1_5_32b,
)
