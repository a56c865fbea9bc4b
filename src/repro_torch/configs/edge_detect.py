"""The paper's own application config: approximate Laplacian edge detection.

Not an LM — the edge pipeline (:mod:`repro_torch.nn.conv`,
:class:`~repro_torch.serving.EdgeDetectService`) is its path; registered
for ``--arch`` completeness so the paper's app is a first-class config.

``dot_plan`` is a ProductSubstrate spec (:mod:`repro_torch.nn.substrate`);
override it to ``"approx_cuda"`` for the CUDA kernels (any wiring at widths
≤ 8, e.g. ``"approx_cuda:csp_axc1@4"``) or ``"approx_lut:<design>"`` for
any baseline wiring.
"""
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import register

CONFIG = register(ModelConfig(
    name="edge-detect",
    family="lm",            # placeholder family; launchers special-case it
    n_layers=1,
    d_model=64,
    n_heads=1,
    n_kv_heads=1,
    d_ff=64,
    vocab=256,
    dot_plan="approx_bitexact:proposed",
))
