#!/usr/bin/env python
"""Top device operations of one compress and one decompress, from a trace.

    python tools/trace_ops.py [--ids-codec device|auto] [--n N] [--top K]
                              [--out DIR]

Workload: N (default 2**25, 128 MB) float32 elements of the climate formula,
EC 1e-3, v2, verify=True, from a host array through the public compress() /
decompress() (the default pipelined path at this size). Every program is
compiled by one untraced round trip first; then one compress and one
decompress run under jax.profiler.trace. Prints one JSON line per direction:
the trace window, the device's busy time (union of its op intervals) and
idle share, and the K device operations with the most total time. The raw
trace stays under DIR (default chiprun_out/trace) for inspection.

Fails when JAX finds no accelerator.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _busy_ns(intervals) -> int:
    """Length of the union of [start, end) intervals."""
    busy, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + (cur_e - cur_s if cur_e is not None else 0)


def reduce_trace(path: str, top: int) -> dict:
    """Device-op totals from an .xplane.pb: ops are the events of each
    device plane's "XLA Ops" line (every line but "XLA Modules" where the
    backend names no such line)."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(path)
    totals = collections.defaultdict(lambda: [0, 0])
    intervals, lines_seen = [], set()
    for plane in pd.planes:
        if not plane.name.startswith("/device:"):
            continue
        lines = list(plane.lines)
        names = {ln.name for ln in lines}
        lines_seen |= names
        keep = [ln for ln in lines if ln.name == "XLA Ops"] or [
            ln for ln in lines if ln.name != "XLA Modules"
        ]
        for ln in keep:
            for ev in ln.events:
                t = totals[ev.name]
                t[0] += int(ev.duration_ns)
                t[1] += 1
                intervals.append(
                    (int(ev.start_ns), int(ev.start_ns + ev.duration_ns))
                )
    if not intervals:
        raise RuntimeError(f"no device operations in {path}")
    window = max(e for _, e in intervals) - min(s for s, _ in intervals)
    busy = _busy_ns(intervals)
    op_ns = sum(t[0] for t in totals.values())
    ranked = sorted(totals.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "device_window_ms": window / 1e6,
        "device_busy_ms": busy / 1e6,
        "device_idle_share": 1.0 - busy / window if window else 0.0,
        "op_time_ms": op_ns / 1e6,
        "top_ops": [
            {"op": name, "ms": ns / 1e6, "count": cnt, "share": ns / op_ns}
            for name, (ns, cnt) in ranked
        ],
        "device_lines": sorted(lines_seen),
    }


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ids-codec", choices=["device", "auto"], default="device")
    p.add_argument("--n", type=int, default=1 << 25)
    p.add_argument("--top", type=int, default=15)
    p.add_argument("--out", default="chiprun_out/trace")
    args = p.parse_args()

    import jax

    import dctz_tpu
    from dctz_tpu import backend
    from dctz_tpu.config import CodecConfig
    from dctz_tpu.eval.datasets import climate_formula
    from dctz_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    dev = backend.require_accelerator()
    cfg = CodecConfig(mode="ec", error_bound=1e-3, container="v2",
                      verify=True, ids_codec=args.ids_codec)
    x = climate_formula(args.n)
    blob = dctz_tpu.compress(x, config=cfg)  # compile everything untraced
    dctz_tpu.decompress(blob)
    for direction, fn in (
        ("compress", lambda: dctz_tpu.compress(x, config=cfg)),
        ("decompress", lambda: dctz_tpu.decompress(blob)),
    ):
        out = os.path.join(args.out, f"{args.ids_codec}-{direction}")
        with jax.profiler.trace(out):
            fn()
        path = sorted(glob.glob(f"{out}/plugins/profile/*/*.xplane.pb"))[-1]
        print(json.dumps({
            "direction": direction, "ids_codec": args.ids_codec,
            "n": args.n, "device_kind": dev.device_kind,
            **reduce_trace(path, args.top),
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
