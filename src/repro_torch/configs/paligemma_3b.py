"""paligemma-3b [vlm] — SigLIP + gemma backbone [arXiv:2407.07726; hf].

18L d_model=2048 8H (GQA kv=1, MQA) d_ff=16384 vocab=257216. The SigLIP
frontend is a STUB: input_specs() provides 256 precomputed patch embeddings.
"""
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import register

CONFIG = register(ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16384,
    vocab=257216,
    head_dim=256,
    n_patches=256,
    rope_theta=1e4,
))
