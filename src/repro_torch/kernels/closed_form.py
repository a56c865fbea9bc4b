"""Kernel-friendly closed forms of the CSP approximate multipliers.

Counterpart of ``repro.kernels.closed_form``, plus the parameter block the
CUDA kernels read.

* :func:`approx_product_i32` — the hand-derived closed form of the paper's
  proposed 8-bit design, kept verbatim as the reference the generator is
  checked against.
* :func:`make_closed_form` — the same algebra generated for any CSP wiring
  at any width 3..16, from the slot taps and the compressor truth tables:

      approx(a,b) = a·b − trunc + comp_n + 2^{n-1}·(a_{n-1}·b_0)
                    + 2^{n-1}·(e_C1a + e_C1b) + 2^n·e_C3     (mod 2^{2n})

  with trunc(a,b) = Σ_{i=0}^{n-2} a_i · 2^i · (b & (2^{n-1-i} − 1)) and each
  slot error a compare-select sum over the *nonzero* truth-table entries.
* :func:`closed_form_params` — the same wiring × width packed into a flat
  int32 block (layout below). ``csrc/closed_form.cuh`` evaluates it on the
  card, and :func:`closed_form_from_params` is its plain twin, loop for
  loop, so the CPU tests hold the device function's algebra. One compiled
  kernel therefore serves every wiring × width: the block is a launch
  argument, not a template parameter.

Parameter block (``PARAM_LEN`` int32 words)::

    [0] n                 operand width
    [1] comp              compensation constant (n-2)·2^(n-3)
    then 3 slots (C1a, C1b, C3), SLOT_LEN words each:
    [+0] n_terms          nonzero (index, error) pairs; 0 = exact slot
    [+1] n_inputs         compressor arity (3 or 4)
    [+2] neg_row          row i of the negative pp ¬(a_i·b_{n-1}), or −1
    [+3] n_taps           positive-pp taps fed (already cut to the arity)
    [+4 .. +9]            taps (i, j) × MAX_TAPS
    [+10] shift           n-1, n-1, n
    [+11 .. +26]          terms (packed_index, error) × MAX_TERMS

The block is built from exactly what ``_build_closed_form`` reads
(``csp_slot_taps``, the compensation constant, ``Compressor.errors``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import compressors as comp
from repro_torch.core import multiplier as mult

Tensor = torch.Tensor

MAX_TAPS = 3   # positive-pp taps per slot (csp_slot_taps)
MAX_TERMS = 8  # nonzero truth-table errors per slot (proposed4 has 8)
SLOT_LEN = 4 + 2 * MAX_TAPS + 1 + 2 * MAX_TERMS
PARAM_LEN = 2 + 3 * SLOT_LEN


def _i32(x) -> Tensor:
    return torch.as_tensor(x).to(torch.int32)


def approx_product_i32(a, b) -> Tensor:
    """Proposed approximate signed product; a, b int32 in [-128, 127]."""
    a = _i32(a)
    b = _i32(b)
    ab = a * b

    # truncated LSP columns 0..6 (7-term masked-operand identity)
    t = torch.zeros_like(ab)
    for i in range(7):
        t = t + (((a >> i) & 1) * ((b & ((1 << (7 - i)) - 1)) << i))

    # NAND→1 conversion ¬(a7·b0) → constant (error +2^7 when a7·b0)
    conv = ((a >> 7) & 1) & (b & 1)

    # approximate A+B+C+D+1 compressor at column 7
    na0b7 = 1 - ((a & 1) & ((b >> 7) & 1))
    p16 = ((a >> 1) & 1) & ((b >> 6) & 1)
    p25 = ((a >> 2) & 1) & ((b >> 5) & 1)
    p34 = ((a >> 3) & 1) & ((b >> 4) & 1)
    s = p16 + p25 + p34
    approx_v = (2 * (na0b7 | (s > 0).to(torch.int32)) + 1
                - (na0b7 & (s == 0).to(torch.int32)))
    e1a = approx_v - (na0b7 + s + 1)

    raw = ab - t + 192 + (conv << 7) + (e1a << 7)

    # wrap to 16-bit two's complement
    u = raw & 0xFFFF
    return torch.where(u >= 0x8000, u - 0x10000, u)


# ---------------------------------------------------------------------------
# Generated closed forms (any wiring × width)
# ---------------------------------------------------------------------------


def _slot_error_terms(c: comp.Compressor) -> list[tuple[int, int]]:
    """(packed_index, error) pairs where the truth table deviates from exact."""
    return [(v, int(e)) for v, e in enumerate(np.asarray(c.errors)) if e]


def _resolve(key: str, n: int | None) -> tuple[str, int]:
    base, kn = mult.split_width(key)
    return mult.WIRING_ALIASES.get(base, base), (n if n is not None else kn)


def _slot_specs(base: str, nb: int):
    """(compressor, negative-pp row or None, taps, shift) per CSP slot."""
    wiring = mult.get_wiring(base)  # rejects "exact" / unknown names
    t1a, t1b, t3 = mult.csp_slot_taps(nb)
    return ((wiring.c1a, 0, t1a, nb - 1), (wiring.c1b, None, t1b, nb - 1),
            (wiring.c3, 1, t3, nb))


def make_closed_form(key: str, n: int | None = None):
    """Elementwise closed-form product fn for a CSP wiring (``"name[@N]"``).

    Returns ``fn(a, b) -> int32`` bit-identical to
    ``core.multiplier.make_multiplier`` at the same wiring/width. ``csp_*``
    aliases resolve; ``"exact"`` is rejected (it has no CSP structure).
    """
    return _build_closed_form(*_resolve(key, n))


@functools.lru_cache(maxsize=None)
def _build_closed_form(base: str, nb: int):
    slot_specs = _slot_specs(base, nb)
    comp_const = mult.compensation_constant(nb)  # validates the width

    def fn(a, b) -> Tensor:
        a = mult.wrap_operand(a, nb)
        b = mult.wrap_operand(b, nb)
        ab = a * b

        # truncation via the (n−1)-term masked-operand identity
        t = torch.zeros_like(ab)
        for i in range(nb - 1):
            t = t + (((a >> i) & 1) * ((b & ((1 << (nb - 1 - i)) - 1)) << i))

        # NAND→1 conversion ¬(a_{n-1}·b_0) → constant
        conv = ((a >> (nb - 1)) & 1) & (b & 1)

        def slot_error(c, neg_row, taps):
            terms = _slot_error_terms(c)
            if not terms:  # exact compressor: no error, no index to pack
                return None
            bits = []
            if neg_row is not None:
                bits.append(1 - (((a >> neg_row) & 1) & ((b >> (nb - 1)) & 1)))
            bits += [((a >> i) & 1) & ((b >> j) & 1) for i, j in taps]
            bits = bits[: c.n_inputs]
            while len(bits) < c.n_inputs:
                bits.append(torch.zeros_like(ab))
            idx = comp.pack_bits(bits)
            err = torch.zeros_like(ab)
            for v, e in terms:
                err = err + e * (idx == v).to(torch.int32)
            return err

        raw = ab - t + comp_const + (conv << (nb - 1))
        for c, neg_row, taps, shift in slot_specs:
            err = slot_error(c, neg_row, taps)
            if err is not None:
                raw = raw + (err << shift)
        return mult.wrap_to_width(raw, 2 * nb)

    fn.__name__ = f"closed_form_{base}@{nb}"
    return fn


@functools.lru_cache(maxsize=None)
def closed_form_f00(key: str, n: int | None = None) -> int:
    """The wiring's product at (0, 0) — the k-padding correction unit."""
    fn = make_closed_form(key, n)
    return int(fn(torch.zeros((), dtype=torch.int32),
                  torch.zeros((), dtype=torch.int32)))


# ---------------------------------------------------------------------------
# The flat parameter block of the CUDA device function
# ---------------------------------------------------------------------------


def closed_form_params(key: str, n: int | None = None) -> np.ndarray:
    """The wiring × width as a flat ``(PARAM_LEN,)`` int32 block (layout in
    the module docstring) — the launch argument of both CUDA kernels."""
    return _params_canonical(*_resolve(key, n)).copy()


@functools.lru_cache(maxsize=None)
def _params_canonical(base: str, nb: int) -> np.ndarray:
    slot_specs = _slot_specs(base, nb)
    p = np.zeros(PARAM_LEN, np.int32)
    p[0] = nb
    p[1] = mult.compensation_constant(nb)
    for s, (c, neg_row, taps, shift) in enumerate(slot_specs):
        terms = _slot_error_terms(c)
        if len(terms) > MAX_TERMS:
            raise ValueError(f"{c.name}: {len(terms)} error terms exceed "
                             f"the parameter block's {MAX_TERMS}")
        fed = taps[: c.n_inputs - (neg_row is not None)]
        o = 2 + s * SLOT_LEN
        p[o] = len(terms)
        p[o + 1] = c.n_inputs
        p[o + 2] = -1 if neg_row is None else neg_row
        p[o + 3] = len(fed)
        for t, (i, j) in enumerate(fed):
            p[o + 4 + 2 * t: o + 6 + 2 * t] = (i, j)
        p[o + 4 + 2 * MAX_TAPS] = shift
        for t, (v, e) in enumerate(terms):
            p[o + 5 + 2 * MAX_TAPS + 2 * t: o + 7 + 2 * MAX_TAPS + 2 * t] = (v, e)
    p.setflags(write=False)
    return p


def _wrap(x: Tensor, bits: int) -> Tensor:
    """``wrap_to_width`` as the device function spells it: shift the low
    ``bits`` to the top, then arithmetic-shift back (sign extension)."""
    if bits >= 32:
        return x
    return (x << (32 - bits)) >> (32 - bits)


def closed_form_from_params(a, b, params) -> Tensor:
    """Evaluate a :func:`closed_form_params` block on int32 tensors.

    The plain twin of ``cf_product`` in ``csrc/closed_form.cuh``, loop for
    loop: the same walk over the block, the same bit packing, the same
    wraps. Bit-identical to :func:`make_closed_form` at the block's key.
    """
    p = [int(v) for v in np.asarray(params)]
    n, comp_const = p[0], p[1]
    a = _wrap(_i32(a), n)
    b = _wrap(_i32(b), n)
    raw = a * b + comp_const
    for i in range(n - 1):
        raw = raw - (((a >> i) & 1) * ((b & ((1 << (n - 1 - i)) - 1)) << i))
    raw = raw + ((((a >> (n - 1)) & 1) & (b & 1)) << (n - 1))
    for s in range(3):
        o = 2 + s * SLOT_LEN
        n_terms, n_inputs, neg_row, n_taps = p[o: o + 4]
        if n_terms == 0:
            continue
        pos = n_inputs - 1  # bit position of the next input, A = MSB
        idx = torch.zeros_like(raw)
        if neg_row >= 0:
            idx = idx | ((1 - (((a >> neg_row) & 1) & ((b >> (n - 1)) & 1))) << pos)
            pos -= 1
        for t in range(n_taps):
            i, j = p[o + 4 + 2 * t], p[o + 5 + 2 * t]
            idx = idx | ((((a >> i) & 1) & ((b >> j) & 1)) << pos)
            pos -= 1
        shift = p[o + 4 + 2 * MAX_TAPS]
        err = torch.zeros_like(raw)
        for t in range(n_terms):
            v = p[o + 5 + 2 * MAX_TAPS + 2 * t]
            e = p[o + 6 + 2 * MAX_TAPS + 2 * t]
            err = err + (idx == v).to(torch.int32) * e
        raw = raw + (err << shift)
    return _wrap(raw, 2 * n)
