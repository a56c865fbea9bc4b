"""Model stack: config, blocks, the dense LM family and its registry.

* :mod:`repro_torch.models.common` — ``ModelConfig``, ``dense`` through the
  substrate registry, attention, FFN, embedding and LM head;
* :mod:`repro_torch.models.lm` — the decoder LM as ``nn.Module``s, with
  ``forward``, ``prefill`` and ``decode_step``;
* :mod:`repro_torch.models.registry` — ``--arch`` names → bundles;
* :mod:`repro_torch.models.convert` — ``repro``'s parameter pytree (as
  numpy arrays) → the port's modules.
"""
