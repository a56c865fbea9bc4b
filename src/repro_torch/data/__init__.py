"""Procedural images (copies of ``repro.data.images``)."""
from repro_torch.data.images import (  # noqa: F401
    image_batch, mixed_shape_batch, photo_like, test_image)
