"""internlm2-20b [dense] — GQA [arXiv:2403.17297; hf].

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544.
"""
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import register

CONFIG = register(ModelConfig(
    name="internlm2-20b",
    family="lm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92544,
    rope_theta=1e6,
))
