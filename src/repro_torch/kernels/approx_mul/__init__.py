"""Elementwise approximate-multiply kernel wrapper (``ops``) and its oracle
(``ref``)."""
