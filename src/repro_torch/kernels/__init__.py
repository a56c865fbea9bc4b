"""Hand-written CUDA kernels for the H100 and their plain torch versions.

* ``closed_form`` — the CSP closed forms in torch, and the flat parameter
  block that ``csrc/closed_form.cuh`` evaluates on the card;
* ``fused_conv`` — batched 'same' conv with every product through the
  closed form or a product table (``csrc/fused_conv.cu``), in a stencil
  design (per-tap product columns, row strips) and a generic design,
  picked by ``fused_conv.ops.stencil_design``;
* ``approx_matmul`` — batched contraction with every product through the
  closed form (``csrc/approx_matmul.cu``);
* ``lut_matmul`` — the same with every product read from a product table
  (``csrc/lut_matmul.cu``); both contractions have a narrow design
  (``csrc/narrow_contract.cuh``), a decode design for few rows
  (``csrc/decode_contract.cuh``), a rows design for many rows on the INT8
  tensor cores (``csrc/rows_contract.cuh``) and a tile design, and
  ``lut_matmul`` a tensor design for the exact product at few rows, picked
  by ``blocking.narrow_design``, ``tensor_design``, ``decode_design`` and
  ``rows_design``;
* ``monomials`` — a product table as an exact int8 GEMM plus bit-monomial
  int8 GEMMs, the rows design's planes;
* ``approx_mul`` — the elementwise proposed@8 product
  (``csrc/approx_mul.cu``);
* ``build`` — nvcc build, ctypes loading and launch counters;
* ``blocking`` — the pad / crop / f(0,0) contract, the contraction
  designs' dispatch rules and their plain twins.

A wrapper runs its kernel for a CUDA tensor and its plain version for a CPU
tensor; ``<wrapper>.launches`` counts kernel launches (per design or kind:
``.narrow_launches``, ``.decode_launches``, ``.rows_launches``,
``lut_matmul.tensor_launches``,
``fused_conv2d.lut_launches``,
``fused_conv2d.stencil_launches``).
"""
