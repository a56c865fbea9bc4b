"""zamba2-1.2b [hybrid] — Mamba2 + shared attn blocks [arXiv:2411.15242; hf].

38L d_model=2048 32H d_ff=8192 vocab=32000, ssm_state=64; one shared
attention block applied every 6 mamba layers. Sub-quadratic: serves
long_500k (O(1) mamba state + shared-block KV).
"""
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import register

CONFIG = register(ModelConfig(
    name="zamba2-1.2b",
    family="zamba",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    ssm_state=64,
    shared_attn_every=6,
))
