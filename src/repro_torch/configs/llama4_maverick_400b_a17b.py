"""llama4-maverick-400b-a17b [moe] — MoE top-1, interleaved every 2nd layer.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1 +
shared expert [hf:meta-llama/Llama-4-Scout-17B-16E; unverified].
Interleave=2 reproduces the ~400B total / ~17B active split.
"""
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import register

CONFIG = register(ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="lm",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    n_experts=128,
    top_k=1,
    moe_interleave=2,
    shared_expert=True,
    rope_theta=5e5,
))
