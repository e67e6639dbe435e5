"""Paper-default mMPU device specs for the cost model (port of
`repro.configs.mmpu_paper`).

Not a model architecture — this module holds the :class:`DeviceSpec`
values the cost model defaults to, with one citation per number:

* 1024x1024 crossbar, 64 arrays — the source paper's evaluation
  configuration (arXiv:2109.09687 §III uses 1024-row arrays; fleet
  size matches the companion ECC paper's multi-array setup).
* 1 GHz device cycle — MAGIC NOR switching completes in ~1.1 ns with
  the standard TEAM-model fitting (Talati et al., TVLSI 2016); the
  canonical mMPU literature rounds to a 1 ns cycle.
* 1-cycle init/NOR/NOT, 1-cycle Min3, 2-cycle XOR — MAGIC executes
  NOR (and the 1-input NOT case) in one cycle after a one-cycle output
  init; FELIX adds single-cycle Min3 and a 2-cycle XOR (Gupta et al.,
  ICCAD 2018) — the exact primitive set the repo's netlists and the
  diagonal-parity ECC of Leitersdorf et al. (arXiv:2105.04212) price
  against.
* energies — per-cell switching energy: ~6.4 fJ per MAGIC NOR
  evaluation (Talati et al.), scaled for the 1-input (NOT) and
  3-input (Min3) cases, 2x NOR for the 2-cycle XOR, ~0.5 fJ sensing
  per read, ~25 fJ SET/RESET per written cell, ~1 fJ init RESET —
  fJ-scale numbers standard across the memristive-logic literature.

Override any field per experiment:

    get_device("paper").replace(rows=512, clock_hz=5e8)
"""
from __future__ import annotations

from typing import Dict

from ..costmodel.device import DeviceSpec

PAPER_MMPU = DeviceSpec(
    name="paper-mmpu",
    rows=1024, cols=1024, n_crossbars=64,
    clock_hz=1.0e9,
    init_cycles=1, nor_cycles=1, not_cycles=1, min3_cycles=1,
    xor_cycles=2, read_cycles=1, write_cycles=1,
    init_energy_pj=0.0010, nor_energy_pj=0.0064, not_energy_pj=0.0032,
    min3_energy_pj=0.0096, xor_energy_pj=0.0128,
    read_energy_pj=0.0005, write_energy_pj=0.0250,
)

#: MAGIC-only device (no FELIX extension): Min3 falls back to the
#: 4-gate NOR decomposition and XOR to a 5-cycle NOR tree — the
#: counterfactual the ECC paper's latency claims are measured against.
MAGIC_NOR_ONLY = PAPER_MMPU.replace(
    name="magic-nor-only", min3_cycles=4, xor_cycles=5,
    min3_energy_pj=4 * PAPER_MMPU.nor_energy_pj,
    xor_energy_pj=5 * PAPER_MMPU.nor_energy_pj)

DEVICES: Dict[str, DeviceSpec] = {
    "paper": PAPER_MMPU,
    "magic-nor-only": MAGIC_NOR_ONLY,
}


def get_device(name: str = "paper") -> DeviceSpec:
    try:
        return DEVICES[name]
    except KeyError:
        raise KeyError(f"unknown mMPU device {name!r}; "
                       f"available: {sorted(DEVICES)}") from None
