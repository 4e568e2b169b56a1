"""The device's side of a traced window, from torch.profiler's trace.

:func:`profiled` runs the window under the profiler and marks it with a
``warpbench.window`` span; :func:`summarize` reads the exported trace:
the seconds some operation ran on the card (kernels, copies, sets, as the
union of their intervals), the window's length on the trace's clock, the
device time of every operation by name, and the idle gaps, each named by
the host stage (a :mod:`warpbench.stages` span) running at its middle.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile
import warnings
from typing import Dict, List, Tuple

WINDOW = "warpbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def profiled(torch, out: Dict):
    """Profile the block; on exit, `out` gets :func:`summarize`'s keys."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            with record_function(WINDOW):
                yield
                torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="warpbench-trace-") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    out.update(summarize(events))


def _name(s: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", s)[:64]


def summarize(trace) -> Dict:
    """``busy_s``, ``window_s``, ``ops`` ({name: device seconds}),
    ``gaps`` ([(host stage, seconds)], longest first) and ``k2_s``,
    ``k2_records`` of a chrome trace (a dict or its event list)."""
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    events = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError(f"the trace has no {WINDOW} span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                  e["name"]) for e in events if e.get("cat") in DEVICE_CATS)
    ops: Dict[str, float] = {}
    k2_s, k2_records = 0.0, 0
    for t0, t1, name in dev:
        ops[_name(name)] = ops.get(_name(name), 0.0) + (t1 - t0) * 1e-6
        if "ws_family_kernel" in name:
            k2_s += (t1 - t0) * 1e-6
            k2_records += 1
    # The union of the device intervals inside the window, and its gaps.
    busy = 0.0
    gaps: List[Tuple[float, float]] = []
    cur = w0
    for t0, t1, _ in dev:
        t0, t1 = max(t0, w0), min(t1, w1)
        if t1 <= cur:
            continue
        if t0 > cur:
            gaps.append((cur, t0))
            cur = t0
        busy += t1 - cur
        cur = t1
    if cur < w1:
        gaps.append((cur, w1))
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e["name"] != WINDOW)
    named = []
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        # The innermost stage span running at the gap's middle.
        inner = [s for s in spans if s[0] <= mid < s[1]]
        label = min(inner, key=lambda s: s[1] - s[0])[2] if inner \
            else "other_host"
        named.append((label, (g1 - g0) * 1e-6))
    named.sort(key=lambda g: -g[1])
    return {"busy_s": busy * 1e-6, "window_s": (w1 - w0) * 1e-6,
            "ops": ops, "gaps": named, "k2_s": k2_s,
            "k2_records": k2_records}


def breakdown(summary: Dict, n: int = 10) -> Dict:
    """The result line's ``breakdown``: the `n` device operations that took
    most time and the `n` longest idle gaps, by host stage."""
    ops = sorted(summary["ops"].items(), key=lambda kv: -kv[1])[:n]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in summary["gaps"][:n]]}
