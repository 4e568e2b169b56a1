"""Machine presets: warp-size baselines, SW+ and LW+ (paper §4, Table 1)."""

from __future__ import annotations

from typing import Dict

from repro_torch.core.warpsim.config import MachineConfig


def baseline(warp_size: int, simd_width: int = 8, **kw) -> MachineConfig:
    return MachineConfig(
        name=f"ws{warp_size}", warp_size=warp_size, simd_width=simd_width, **kw)


def sw_plus(simd_width: int = 8, **kw) -> MachineConfig:
    """Small warps (= SIMD width) + ideal cross-warp read coalescing."""
    return MachineConfig(
        name="SW+", warp_size=simd_width, simd_width=simd_width,
        ideal_coalescing=True, **kw)


def lw_plus(simd_width: int = 8, **kw) -> MachineConfig:
    """Large warps (8x SIMD width) + MIMD engine (no divergence cost)."""
    return MachineConfig(
        name="LW+", warp_size=8 * simd_width, simd_width=simd_width,
        mimd=True, **kw)


def paper_suite(simd_width: int = 8) -> Dict[str, MachineConfig]:
    """The machines of Figures 5-7: ws8/16/32/64, SW+ and LW+."""
    suite = {f"ws{w}": baseline(w, simd_width) for w in (8, 16, 32, 64)}
    suite["SW+"] = sw_plus(simd_width)
    suite["LW+"] = lw_plus(simd_width)
    return suite


def expansion_groups(machine_set: Dict[str, MachineConfig]
                     ) -> Dict[tuple, list]:
    """Machine names bucketed by :meth:`MachineConfig.expansion_key`.

    Machines in one bucket produce identical ``aggregate_stream`` output
    for any workload, so the sweep aggregates one
    :class:`~repro_torch.core.warpsim.divergence.WarpStream` per bucket (in
    the paper suite SW+ rides on ws8's stream: 5 buckets for 6 machines).
    """
    groups: Dict[tuple, list] = {}
    for name, cfg in machine_set.items():
        groups.setdefault(cfg.expansion_key(), []).append(name)
    return groups
