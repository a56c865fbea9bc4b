"""Approximate neural-network layers over the product-substrate registry.

``repro_torch.nn.substrate`` holds the registry (``exact``,
``approx_bitexact``, ``approx_lut``, ``approx_cuda`` / ``approx_pallas``);
``repro_torch.nn.conv`` the convolution and edge-detection pipeline;
``repro_torch.nn.approx_dot`` the historical function façade over the
registry.
"""
from repro_torch.nn import approx_dot, conv, quant, substrate  # noqa: F401
from repro_torch.nn.substrate import (  # noqa: F401
    ContractionSpec,
    QuantPolicy,
    SubstrateMeta,
    get_substrate,
    list_substrates,
)
