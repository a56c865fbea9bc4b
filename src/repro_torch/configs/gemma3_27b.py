"""gemma3-27b [dense] — 5:1 local:global attention, 128k context.

62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144
[hf:google/gemma-3; unverified]. Local window 1024.
"""
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import register

CONFIG = register(ModelConfig(
    name="gemma3-27b",
    family="lm",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    d_ff=21504,
    vocab=262144,
    head_dim=128,
    local_window=1024,
    local_global_ratio=5,
    rope_theta=1e6,
))
