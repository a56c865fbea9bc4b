"""minitron-8b [dense] — pruned nemotron [arXiv:2407.14679; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.
"""
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import register

CONFIG = register(ModelConfig(
    name="minitron-8b",
    family="lm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=16384,
    vocab=256000,
    rope_theta=5e5,
))
