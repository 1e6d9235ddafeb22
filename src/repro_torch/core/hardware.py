"""Hardware specifications for runtime prediction and roofline analysis.

The emulator presents *virtual devices* of a configurable target platform
(§4.3: "a researcher ... can simply configure REVATI to emulate the desired
hardware").  The same specs drive:

* the analytical runtime predictor (`repro.core.predictor`),
* the roofline terms reported by `benchmarks/roofline.py`:

    compute    = HLO_FLOPs        / (chips × peak_flops)
    memory     = HLO_bytes        / (chips × hbm_bw)
    collective = collective_bytes / (chips × link_bw)

TPU v5e is the primary target (per the assignment); the paper's H100/H200 are
included so the fidelity benchmarks can model the paper's own setup; A100 and
L4 fill out the cheaper tiers a heterogeneous pool autoscales into.

Chips double as the **hardware tiers** of the heterogeneous cluster layer
(``repro.cluster``): each replica carries a tier name, and tier-aware routing
and autoscaling weigh replicas by throughput and ``cost_per_hour``.  Short
tier aliases (``"h100"``, ``"a100"``, ``"l4"`` …) resolve through
:func:`get_chip`:

>>> get_chip("l4").name
'l4'
>>> get_chip("h100") is get_chip("h100-sxm")
True
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["ChipSpec", "TPU_V5E", "H100", "H200", "A100", "L4", "CHIPS",
           "CHIP_ALIASES", "get_chip"]


@dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_flops_bf16: float      # FLOP/s, dense
    hbm_bandwidth: float        # bytes/s
    hbm_capacity: float         # bytes
    interconnect_bandwidth: float  # bytes/s per link (ICI / NVLink per-dir)
    interconnect_links: int     # links per chip (torus degree / NVLink count)
    # Empirical efficiency ceilings used by the analytical predictor.  These
    # are calibration knobs, not physics: large aligned matmuls reach ~70–85%
    # of peak on both MXU and tensor cores; HBM streams reach ~80–90%.
    matmul_efficiency: float = 0.65
    hbm_efficiency: float = 0.80
    collective_efficiency: float = 0.85
    # Cost model for the heterogeneous-pool sweeps: representative public
    # on-demand $/chip-hour.  A calibration knob like the efficiencies — the
    # benchmarks compare *relative* tier costs, not cloud invoices.
    cost_per_hour: float = 0.0

    @property
    def flops_per_byte(self) -> float:
        """Roofline ridge point (bf16)."""
        return self.peak_flops_bf16 / self.hbm_bandwidth

    @property
    def cost_per_second(self) -> float:
        """$/chip-second (derived from :attr:`cost_per_hour`).

        >>> round(ChipSpec("x", 1, 1, 1, 1, 1, cost_per_hour=3600.0)
        ...       .cost_per_second, 6)
        1.0
        """
        return self.cost_per_hour / 3600.0


TPU_V5E = ChipSpec(
    name="tpu-v5e",
    peak_flops_bf16=197e12,          # per assignment: 197 TFLOP/s bf16
    hbm_bandwidth=819e9,             # 819 GB/s
    hbm_capacity=16e9,               # 16 GB
    interconnect_bandwidth=50e9,     # ~50 GB/s per ICI link
    interconnect_links=4,            # 2D torus
    cost_per_hour=1.2,
)

H100 = ChipSpec(
    name="h100-sxm",
    peak_flops_bf16=989e12,
    hbm_bandwidth=3.35e12,
    hbm_capacity=80e9,
    interconnect_bandwidth=450e9,    # NVLink4 per direction
    interconnect_links=1,
    cost_per_hour=5.5,
)

H200 = ChipSpec(
    name="h200-sxm",
    peak_flops_bf16=989e12,
    hbm_bandwidth=4.8e12,
    hbm_capacity=141e9,
    interconnect_bandwidth=450e9,
    interconnect_links=1,
    cost_per_hour=6.8,
)

A100 = ChipSpec(
    name="a100-sxm",
    peak_flops_bf16=312e12,
    hbm_bandwidth=2.0e12,
    hbm_capacity=80e9,
    interconnect_bandwidth=300e9,
    interconnect_links=1,
    cost_per_hour=3.0,
)

L4 = ChipSpec(
    name="l4",
    peak_flops_bf16=121e12,          # dense bf16 tensor
    hbm_bandwidth=300e9,             # GDDR6
    hbm_capacity=24e9,
    interconnect_bandwidth=32e9,     # PCIe gen4 x16 (no NVLink)
    interconnect_links=1,
    cost_per_hour=0.8,
)

CHIPS = {c.name: c for c in (TPU_V5E, H100, H200, A100, L4)}

# Short tier names used by the heterogeneous cluster layer (EngineConfig.chip
# and the canonical names keep working everywhere).
CHIP_ALIASES = {
    "h100": "h100-sxm",
    "h200": "h200-sxm",
    "a100": "a100-sxm",
    "v5e": "tpu-v5e",
}


def get_chip(name: str) -> ChipSpec:
    """Resolve a chip/tier name (canonical or alias) to its spec.

    >>> get_chip("a100").cost_per_hour < get_chip("h100").cost_per_hour
    True
    >>> get_chip("warp-drive")
    Traceback (most recent call last):
        ...
    KeyError: "unknown chip 'warp-drive'; known: ['a100', 'a100-sxm', \
'h100', 'h100-sxm', 'h200', 'h200-sxm', 'l4', 'tpu-v5e', 'v5e']"
    """
    key = CHIP_ALIASES.get(name, name)
    try:
        return CHIPS[key]
    except KeyError:
        known = sorted(set(CHIPS) | set(CHIP_ALIASES))
        raise KeyError(f"unknown chip {name!r}; known: {known}") from None
