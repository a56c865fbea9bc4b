"""The current mesh of the models.

Counterpart of ``repro.models.sharding``'s mesh. ``repro`` makes a mesh
current with ``with mesh:``; here a mesh is current inside
:func:`mesh_scope` (thread-local, as the other ambients of the port), and
the expert-parallel MoE reads it (:func:`current_mesh`).

``repro``'s logical-axis rules table, ``spec`` and ``constrain`` serve its
compiler (GSPMD) and its dry-run tooling; the port is eager and SPMD, so
the places where ``repro`` relies on GSPMD (the expert-parallel MoE, the
data-parallel step) call their collectives themselves, and the table comes
with the dry-run tooling (ROADMAP.md, queue 1 item 12).
"""
from __future__ import annotations

import contextlib
import threading

_state = threading.local()


def current_mesh():
    """The ``DeviceMesh`` of the enclosing :func:`mesh_scope`, or None."""
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def mesh_scope(mesh):
    """Make ``mesh`` current for the block (``repro``'s ``with mesh:``);
    ``None`` clears it. Thread-local: a block run on another thread (the
    recompute of a checkpointed layer) enters it again."""
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev
