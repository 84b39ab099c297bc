"""The traced window: torch.profiler over the first TRACE_SECONDS of the
window, reduced to the device's busy time, the operations that took most
of it, the longest idle gaps by what the host was doing, and the
launches of named kernels.

Only a run with ``--trace 1`` opens the profiler; its numbers are the
per-layer metrics', never the end-to-end ones.
"""

from __future__ import annotations

import torch

TOP = 10
# the traced part of a window: from its start to the first adjustment
# boundary after this many seconds (the rest of the window runs untraced,
# so that the trace's events stay few enough to read within the run)
TRACE_SECONDS = 8.0


def start():
    """A started profiler of the host's and the card's activity."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts, record_shapes=False)
    prof.start()
    return prof


def short(name: str, width: int = 96) -> str:
    """A kernel's name without its return type and arguments, cut to
    `width` characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):  # cut at the first "(" outside template brackets
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i:
            name = name[:i].rstrip()
            break
    return name if len(name) <= width else name[: width - 3] + "..."


def _intervals(prof):
    """(device, host): lists of (start_us, end_us, name) of the device's
    kernels and memory operations, and of the host's operations."""
    dev, host = [], []
    for e in prof.events():
        tr = e.time_range
        if tr.end <= tr.start:
            continue
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((tr.start, tr.end, e.name))
        else:
            host.append((tr.start, tr.end, e.name))
    return dev, host


def _merge(iv):
    """Union of intervals, sorted: [(start, end)]."""
    out = []
    for s, e, _ in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(prof, window_s: float, kernel_names=()) -> dict:
    """busy_s (the union of the device's operations), window_s, the
    breakdown (device_ops: seconds by name, most first; idle_gaps: the
    longest gaps between device operations inside the traced span, named
    by the innermost host operation running at the gap's middle) and
    the device launches whose names contain each of `kernel_names`."""
    dev, host = _intervals(prof)
    merged = _merge(dev)
    busy_us = sum(e - s for s, e in merged)
    by_name = {}
    for s, e, name in dev:
        key = short(name)
        by_name[key] = by_name.get(key, 0.0) + (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    named = []
    for a, b in gaps:
        mid = (a + b) / 2
        inner = [h for h in host if h[0] <= mid <= h[1]]
        name = short(max(inner, key=lambda h: h[0])[2]) if inner else "host: no operation traced"
        named.append([name, (b - a) / 1e6])
    launches = {k: sum(1 for _, _, name in dev if k in name) for k in kernel_names}
    return dict(busy_s=busy_us / 1e6, window_s=window_s,
                breakdown=dict(device_ops=[[n, s] for n, s in ops], idle_gaps=named),
                launches=launches, device_events=len(dev))
