"""whisper-large-v3 [audio] — enc-dec, conv frontend stub [arXiv:2212.04356].

32 encoder + 32 decoder layers, d_model=1280 20H (kv=20) d_ff=5120
vocab=51866; 1500 post-conv audio frames (stub embeddings).
"""
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import register

CONFIG = register(ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,
    n_encoder_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51866,
    n_frames=1500,
    rope_theta=1e4,
))
