"""Procedural images and the synthetic LM stream (copies of
``repro.data.images`` and ``repro.data.synthetic``)."""
from repro_torch.data.images import (  # noqa: F401
    image_batch, mixed_shape_batch, photo_like, test_image)
from repro_torch.data.synthetic import SyntheticLMStream  # noqa: F401
