"""Hand-written CUDA kernels for the H100 and their plain torch versions.

* ``closed_form`` — the CSP closed forms in torch, and the flat parameter
  block that ``csrc/closed_form.cuh`` evaluates on the card;
* ``fused_conv`` — batched 'same' conv with every product through the
  closed form (``csrc/fused_conv.cu``);
* ``approx_matmul`` — batched contraction with every product through the
  closed form (``csrc/approx_matmul.cu``);
* ``build`` — nvcc build, ctypes loading and launch counters;
* ``blocking`` — the pad / crop / f(0,0) contract.

A wrapper runs its kernel for a CUDA tensor and its plain version for a CPU
tensor; ``<wrapper>.launches`` counts kernel launches.
"""
