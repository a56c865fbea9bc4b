"""Approximate contraction kernel wrapper (``ops``)."""
