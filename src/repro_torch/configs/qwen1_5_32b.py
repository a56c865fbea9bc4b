"""qwen1.5-32b [dense] — QKV bias [hf:Qwen/Qwen1.5; hf].

64L d_model=5120 40H (GQA kv=40) d_ff=27392 vocab=152064.
"""
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import register

CONFIG = register(ModelConfig(
    name="qwen1.5-32b",
    family="lm",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1e6,
))
