"""Profiling: device-time breakdown for a jitted step.

Replaces the reference's commented-out ProfilerHook + wall-clock prints
(deepfm/deepfm.py:195,207-210 — SURVEY §5.1) with `jax.profiler` traces plus
a parser that attributes device time to HLO fusions and maps them back to
framework source lines (the gather/scatter/matmul attribution used to drive
the hybrid embedding engine design).

Device time comes from the device planes of the trace (``/device:GPU:0``
and so on): host wall-clock around a dispatch measures the enqueue, not
the work.
"""

from __future__ import annotations

import collections
import glob
import os
import re
import tempfile


def trace_step(fn, *args, trace_dir: str | None = None) -> str:
    """Run ``fn(*args)`` once under the JAX profiler; returns trace dir."""
    import jax

    trace_dir = trace_dir or tempfile.mkdtemp(prefix="recsys_trace_")
    with jax.profiler.trace(trace_dir):
        out = fn(*args)
        jax.tree.map(
            lambda x: float(x.reshape(-1)[0]) if hasattr(x, "reshape") else x,
            jax.tree.leaves(out)[0],
        )
    return trace_dir


def device_breakdown(trace_dir: str, top: int = 15) -> list[dict]:
    """Top device kernels of the newest trace under ``trace_dir`` by total
    duration, from its ``/device:*`` planes (one line per stream). Kernels
    are keyed by their own name, the HLO fusion they run: inside a
    command buffer every kernel's ``hlo_op`` is the buffer's."""
    import jax

    paths = glob.glob(
        os.path.join(trace_dir, "plugins/profile/*/*.xplane.pb"))
    if not paths:
        raise FileNotFoundError(f"no trace under {trace_dir}")
    data = jax.profiler.ProfileData.from_file(sorted(paths)[-1])
    dur = collections.Counter()
    cnt = collections.Counter()
    hlo_op: dict = {}
    for plane in data.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            for e in line.events:
                dur[e.name] += e.duration_ns
                cnt[e.name] += 1
                hlo_op.setdefault(e.name, dict(e.stats).get("hlo_op"))
    return [{"op": name, "total_ms": d / 1e6, "count": cnt[name],
             "hlo_op": hlo_op[name]} for name, d in dur.most_common(top)]


def annotate_with_hlo(rows: list[dict], compiled_text: str) -> list[dict]:
    """Attach op_name/source_file metadata from compiled HLO text."""
    for row in rows:
        m = re.search(
            rf'%?{re.escape(row["op"])} = [^\n]+', compiled_text
        )
        if m:
            line = m.group(0)
            meta = re.search(r'metadata=\{([^}]*)\}', line)
            row["hlo"] = line[:160]
            if meta:
                om = re.search(r'op_name="([^"]*)"', meta.group(1))
                sf = re.search(r'source_file="([^"]*)"', meta.group(1))
                row["op_name"] = om.group(1) if om else None
                row["source_file"] = sf.group(1) if sf else None
    return rows


def print_breakdown(rows: list[dict]) -> None:
    for r in rows:
        src = r.get("op_name") or ""
        print(f"{r['total_ms']:10.3f} ms  x{r['count']:4d}  {r['op'][:40]:40s}"
              f"  {src[:80]}")
