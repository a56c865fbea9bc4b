"""LUT-input contraction kernel wrapper (``ops``) and its oracle (``ref``)."""
