"""kimi-k2-1t-a32b [moe] — trillion-param MoE (paper-table).

61L d_model=7168 64H (GQA kv=8) d_ff=2048 (expert dim) vocab=163840,
MoE 384e top-8 + shared expert [arXiv:2501.kimi2; unverified].
"""
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import register

CONFIG = register(ModelConfig(
    name="kimi-k2-1t-a32b",
    family="lm",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab=163840,
    n_experts=384,
    top_k=8,
    moe_interleave=1,
    shared_expert=True,
    rope_theta=5e4,
))
