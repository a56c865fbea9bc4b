"""Fused conv kernel wrapper (``ops``) and its scalar oracle (``ref``)."""
