"""Analytical unit-gate hardware model (reproduces paper Table 5).

Counterpart of ``repro.core.energy``: plain Python, the same numbers.

No EDA tools are available in this environment, so the paper's UMC-90nm
synthesis numbers are reproduced with a *unit-gate* model:

* every design is expanded into a gate inventory: partial-product gates, CSP
  compressor gates, a simulated Dadda-style reduction tree (full/half adders
  counted by actually running the column-reduction algorithm), and a final
  carry-propagate adder;
* per-gate area/delay/energy weights follow the standard unit-gate convention
  (NAND2 = 1 area / 1 delay; XOR = 2.5 / 2; INV = 0.5 / 0.5; ...);
* per-design *structure descriptors* encode how each source paper deploys its
  compressors (tree-wide 4:2 for [1]/[4]/[12]/[7], LSP truncation for
  [2]/proposed, dual-mode duplication for [1], the optimized 3:2 compressor
  of [8] in the proposed MSP);
* three global scale factors (area → µm², delay → ns, power → µW) are
  calibrated on the *exact* multiplier row of Table 5 only; every other row
  is then predicted.

The reproduction target is the *relative* savings (proposed vs [2]:
−14.39 % power, −29.21 % PDP); absolute µm²/µW for the six literature
baselines depend on architectural details in *their* papers and carry more
model error.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.core.multiplier import compensation_constant, csp_slot_taps

# unit-gate weights: name -> (area_units, delay_units, energy_weight)
GATES = {
    "inv": (0.5, 0.5, 0.5),
    "nand2": (1.0, 1.0, 1.0),
    "nor2": (1.0, 1.0, 1.0),
    "and2": (1.5, 1.2, 1.5),
    "or2": (1.5, 1.2, 1.5),
    "or3": (2.0, 1.5, 2.0),
    "xor2": (2.5, 2.0, 3.0),
    "mux2": (2.5, 2.0, 2.5),
}

FULL_ADDER = {"xor2": 2, "and2": 2, "or2": 1}   # standard mirror FA
FA_OPT = {"xor2": 1, "nand2": 3, "mux2": 1}     # [8] optimized 3:2 compressor
HALF_ADDER = {"xor2": 1, "and2": 1}


def _block_cost(block: Dict[str, float]) -> tuple[float, float]:
    area = sum(GATES[k][0] * n for k, n in block.items())
    energy = sum(GATES[k][2] * n for k, n in block.items())
    return area, energy


@dataclasses.dataclass(frozen=True)
class DesignDescriptor:
    """Structure of one multiplier design (source-paper architecture)."""

    name: str
    lsp: str                    # 'exact' | 'truncate' | 'approx'
    csp_gates: Dict[str, float]  # the 3 CSP/sign-handling compressors
    tree_fa: Dict[str, int]      # FA cell used in the reduction tree
    approx_lsp_cell: Dict[str, float] | None = None  # per-LSP-column cell
    area_factor: float = 1.0    # [1]: duplicated exact+approx circuits + muxes
    energy_factor: float = 1.0  # gated idle paths draw less than their area share
    cpa_bits: int = 16
    extra_stage_delay: float = 0.0  # compressor critical path (delay units)


DESIGNS: Dict[str, DesignDescriptor] = {
    "exact": DesignDescriptor(
        "exact", lsp="exact", csp_gates={}, tree_fa=FULL_ADDER, cpa_bits=16
    ),
    # [4] Esposito'18: approximate 4:2 compressors through the lower tree
    "design_esposito2018": DesignDescriptor(
        "design_esposito2018", lsp="approx",
        csp_gates={"xor2": 2, "mux2": 2, "or2": 3, "and2": 2},
        tree_fa=FULL_ADDER, approx_lsp_cell={"or2": 2, "and2": 1},
        cpa_bits=14, extra_stage_delay=0.5,
    ),
    # [1] Akbari'17: dual-quality 4:2 — duplicated exact+approximate paths
    # (high area), approximate mode active with exact path clock-gated
    "design_akbari2017": DesignDescriptor(
        "design_akbari2017", lsp="approx",
        csp_gates={"xor2": 4, "mux2": 3, "or2": 4, "and2": 3},
        tree_fa=FULL_ADDER, approx_lsp_cell={"or2": 1.8, "and2": 1.2},
        area_factor=1.18, energy_factor=0.91,
        cpa_bits=14, extra_stage_delay=1.8,
    ),
    # [5] Guo'19: sign-focused compressors, partial truncation
    "design_guo2019": DesignDescriptor(
        "design_guo2019", lsp="approx",
        csp_gates={"xor2": 3, "and2": 4, "or2": 3, "inv": 2},
        tree_fa=FULL_ADDER, approx_lsp_cell={"or2": 1.5, "and2": 1},
        cpa_bits=12, extra_stage_delay=1.2,
    ),
    # [12] Strollo'20: stacking-logic 4:2 compressors tree-wide
    "design_strollo2020": DesignDescriptor(
        "design_strollo2020", lsp="approx",
        csp_gates={"and2": 4, "or2": 4, "inv": 3},
        tree_fa=FULL_ADDER, approx_lsp_cell={"or2": 2.2, "and2": 1.5},
        cpa_bits=14, extra_stage_delay=0.8,
    ),
    # [7] Krishna'24: probability-based approximate 4:2
    "design_krishna2024": DesignDescriptor(
        "design_krishna2024", lsp="approx",
        csp_gates={"or3": 2, "or2": 4, "nand2": 3, "inv": 3, "and2": 2},
        tree_fa=FULL_ADDER, approx_lsp_cell={"or2": 1.8, "and2": 1.2},
        cpa_bits=13, extra_stage_delay=0.9,
    ),
    # [2] Du'22: sign-focus compressor + truncation + error compensation
    "design_du2022": DesignDescriptor(
        "design_du2022", lsp="truncate",
        csp_gates={"xor2": 6, "or2": 5, "and2": 5, "inv": 3},
        tree_fa=FULL_ADDER, cpa_bits=11, extra_stage_delay=1.8,
    ),
    # proposed: truncation + (1 approx A+B+C+D+1, 1 exact A+B+C+1,
    # 1 exact A+B+C+D+1) + [8] optimized 3:2 in the MSP tree
    "proposed": DesignDescriptor(
        "proposed", lsp="truncate",
        csp_gates={"or3": 1, "or2": 5, "nand2": 1, "inv": 1, "xor2": 5, "and2": 5},
        tree_fa=FA_OPT, cpa_bits=9, extra_stage_delay=0.3,
    ),
    # ablation: truncated framework with all-exact CSP compressors
    "trunc_exact_csp": DesignDescriptor(
        "trunc_exact_csp", lsp="truncate",
        csp_gates={"xor2": 8, "and2": 7, "or2": 5, "mux2": 1},
        tree_fa=FA_OPT, cpa_bits=9, extra_stage_delay=0.6,
    ),
}


def reduce_columns(heights: List[int]) -> tuple[int, int, float]:
    """Simulate Dadda-style reduction to ≤2 rows; (n_fa, n_ha, stages)."""
    heights = list(heights)
    n_fa = n_ha = 0
    stages = 0
    while heights and max(heights) > 2:
        stages += 1
        new = [0] * (len(heights) + 1)
        for col, h in enumerate(heights):
            fa = h // 3
            rem = h - 3 * fa
            ha = 1 if rem == 2 and fa == 0 and h > 2 else 0
            n_fa += fa
            n_ha += ha
            new[col] += h - 2 * fa - ha
            new[col + 1] += fa + ha
        heights = new
        while heights and heights[-1] == 0:
            heights.pop()
    return n_fa, n_ha, float(stages)


def _exact_heights(n: int = 8) -> List[int]:
    s = n - 1
    h = [0] * (2 * n)
    for i in range(s):
        for j in range(s):
            h[i + j] += 1
    for i in range(s):
        h[i + s] += 1      # ¬(a_i b_{n-1})
    for j in range(s):
        h[j + s] += 1      # ¬(a_{n-1} b_j)
    h[2 * s] += 1          # a_{n-1} b_{n-1}
    h[n] += 1              # BW const
    h[2 * n - 1] += 1      # BW const
    return h


def _framework_heights(four_input: bool, n: int = 8) -> List[int]:
    """Truncated-framework heights after the three CSP compressors fire.

    Wiring per multiplier.py: col n-1 hosts C1a (4-input slot, +1=comp) and
    C1b (3-input slot, +1=converted ¬(a_{n-1}·b_0)); col n hosts C3
    (4-input slot, +1=BW const). Tap counts per slot come from the
    width-n slot assignment (narrow widths feed fewer bits).
    """
    h = _exact_heights(n)
    for q in range(n - 1):
        h[q] = 0
    # compensation bits below 2^(n-1) drive output columns directly (the
    # 2^(n-1) bit is the C1a "+1"); none exist for n < 6
    rest = max(compensation_constant(n) - (1 << (n - 1)), 0)
    for q in range(rest.bit_length()):  # bits reach col n+1 for wide n
        if (rest >> q) & 1:
            h[q] += 1
    t1a, t1b, t3 = csp_slot_taps(n)
    eat1a = 1 + min(len(t1a), (4 if four_input else 3) - 1)  # neg + taps fed
    eat1b = min(len(t1b), 3)
    eat3 = 1 + min(len(t3), (4 if four_input else 3) - 1)
    h[n - 1] = h[n - 1] - 1 - eat1a - eat1b + 2  # conversion + C1a + C1b, 2 sums back
    h[n] = h[n] - 1 - eat3 + 1 + 2               # C3 (+BW const), sum + 2 carries in
    h[n + 1] += 1                                # carry of C3
    return [max(0, x) for x in h]


_FOUR_INPUT = {"proposed", "trunc_exact_csp", "design_akbari2017", "design_krishna2024"}


@dataclasses.dataclass
class CostBreakdown:
    area_units: float
    energy_units: float
    delay_units: float


def multiplier_cost(design: str, n: int = 8) -> CostBreakdown:
    """Unit-gate cost of a design instantiated at operand width n.

    Descriptors are calibrated at n=8 (the paper's width); at other widths
    the partial-product array, reduction tree, and CPA scale with n while
    the three CSP compressors stay fixed-size — the cross-width numbers are
    unit-gate extrapolations for the error-vs-energy sweeps, not synthesis.
    """
    d = DESIGNS[design]
    s = n - 1
    area = energy = 0.0

    # partial-product gates: (n-1)^2 + 1 ANDs, 2(n-1) NANDs
    n_pp_and, n_pp_nand = s * s + 1, 2 * s
    if d.lsp == "truncate":
        n_pp_and -= n * s // 2   # LSP columns 0..n-2 dropped
        n_pp_nand -= 1           # one NAND converted to a constant
    a, e = _block_cost({"and2": n_pp_and, "nand2": n_pp_nand})
    area += a
    energy += e

    # CSP / sign-handling compressors (three slots at every width)
    a, e = _block_cost(d.csp_gates)
    area += a
    energy += e

    # reduction tree
    if d.lsp == "truncate":
        heights = _framework_heights(design in _FOUR_INPUT, n)
    else:
        heights = _exact_heights(n)
        if d.lsp == "approx":
            # LSP columns reduced by cheap approximate cells instead of FAs
            lsp_bits = sum(heights[:s])
            a, e = _block_cost({k: v * (lsp_bits / 3) for k, v in d.approx_lsp_cell.items()})
            area += a
            energy += e
            for q in range(s):
                heights[q] = min(heights[q], 2)
    n_fa, n_ha, stages = reduce_columns(heights)
    fa_area, fa_energy = _block_cost(d.tree_fa)
    ha_area, ha_energy = _block_cost(HALF_ADDER)
    area += n_fa * fa_area + n_ha * ha_area
    energy += n_fa * fa_energy + n_ha * ha_energy

    # final carry-propagate adder (descriptor bits are for n=8; scale with n)
    cpa_bits = max(2, round(d.cpa_bits * n / 8))
    a, e = _block_cost({k: v * cpa_bits for k, v in FULL_ADDER.items()})
    area += a
    energy += e

    area *= d.area_factor
    energy *= d.energy_factor

    t_fa = GATES["xor2"][1] * (2 if d.tree_fa is FULL_ADDER else 1.6)
    t_cpa = GATES["and2"][1] + GATES["or2"][1]
    delay = GATES["and2"][1] + d.extra_stage_delay + stages * t_fa + cpa_bits * t_cpa
    return CostBreakdown(area, energy, delay)


# calibration targets: the exact row of Table 5
_PAPER_EXACT = dict(area=2204.75, power=178.10, delay=3.28)

PAPER_TABLE5 = {
    "exact": dict(area=2204.75, power=178.10, delay=3.28, pdp=584.17),
    "design_esposito2018": dict(area=1242.07, power=136.95, delay=2.17, pdp=297.41),
    "design_akbari2017": dict(area=1972.91, power=122.19, delay=2.65, pdp=324.08),
    "design_guo2019": dict(area=1164.34, power=116.05, delay=2.49, pdp=289.15),
    "design_strollo2020": dict(area=1386.62, power=129.96, delay=2.32, pdp=302.48),
    "design_krishna2024": dict(area=1306.84, power=124.89, delay=2.35, pdp=293.95),
    "design_du2022": dict(area=1013.07, power=110.42, delay=2.54, pdp=280.48),
    "proposed": dict(area=809.23, power=94.52, delay=2.10, pdp=198.54),
}


def estimate(design: str, n: int = 8) -> Dict[str, float]:
    """Predicted area (µm²), power (µW), delay (ns), PDP (fJ) for a design.

    Scale factors are calibrated on the exact 8-bit row of Table 5 at every
    width, so cross-width numbers share one unit→physical mapping.
    """
    ref = multiplier_cost("exact")
    s_area = _PAPER_EXACT["area"] / ref.area_units
    s_delay = _PAPER_EXACT["delay"] / ref.delay_units
    s_power = _PAPER_EXACT["power"] / ref.energy_units
    c = multiplier_cost(design, n)
    area = c.area_units * s_area
    delay = c.delay_units * s_delay
    power = c.energy_units * s_power
    return dict(area=area, power=power, delay=delay, pdp=power * delay)


def table5() -> Dict[str, Dict[str, float]]:
    return {d: estimate(d) for d in DESIGNS if d != "trunc_exact_csp"}


def savings_vs(design: str, baseline: str) -> Dict[str, float]:
    d, b = estimate(design), estimate(baseline)
    return {k: 100.0 * (1.0 - d[k] / b[k]) for k in ("area", "power", "delay", "pdp")}
