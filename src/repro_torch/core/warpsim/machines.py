"""Machine presets: warp-size baselines, SW+ and LW+ (paper §4, Table 1)."""

from __future__ import annotations

from typing import Dict, Iterable

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


def warp_size_sweep(simd_width: int, multipliers: Iterable[int] = (1, 2, 4, 8)
                    ) -> Dict[str, MachineConfig]:
    """Figure 1: warp sizes {1,2,4,8}x SIMD width for a given SIMD width."""
    return {
        f"simd{simd_width}_ws{m * simd_width}":
            baseline(m * simd_width, simd_width)
        for m in multipliers
    }


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


def sharing_plan(machine_set: Dict[str, MachineConfig]) -> str:
    """One-line summary of the expansion sharing a machine set enjoys,
    e.g. ``"6 machines -> 1 thread trace + 5 aggregations per workload"``."""
    groups = expansion_groups(machine_set)
    return (f"{len(machine_set)} machines -> 1 thread trace + "
            f"{len(groups)} aggregations per workload")
