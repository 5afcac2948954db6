#!/usr/bin/env python
"""DCTZ-TPU benchmark on one GPU. Prints ONE JSON line:
    {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ..., "detail": ...}

Workload: 2**25 elements (128 MB) of the climate formula
(eval.datasets.climate_formula), EC at 1e-3, v2 container, verify=True,
device-coded ids (ids_codec="device"). compress() takes its default
pipelined DTZS path at this size.

Headline: compress + decompress throughput of the public API from a host
NumPy array, 2 * bytes / (compress_s + decompress_s), each the median of
REPS measured wall-clock runs (decompress always returns a host array, so
every timing ends with the result on the host). The same is reported for a
device-resident jax.Array input, plus the monolithic path's per-stage split
(StageTimer(sync=True): block_until_ready at the device-stage boundaries).
Correctness: the FULL decompressed array against the input
(utils.metrics.evaluate). vs_baseline: the native C++ reference codec
(cpp/dctz_ref.cpp) on this host's CPU.

Fails when JAX finds no accelerator. Layer metrics from a profiler trace
(kernel time, roofline share, idle share) are not measured here yet.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

N = 1 << 25  # 32Mi elements, 128 MB float32
EB = 1e-3
REPS = 5


def gpu_name_and_power_limit() -> str:
    """`name, power.limit` as nvidia-smi reports them (one line per card)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def _median_s(fn, reps: int = REPS) -> float:
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        samples.append(time.perf_counter() - t0)
    return statistics.median(samples)


def bench_jax() -> dict:
    import jax
    import jax.numpy as jnp

    from dctz_tpu import compress, decompress, evaluate
    from dctz_tpu.config import CodecConfig
    from dctz_tpu.eval.datasets import climate_formula
    from dctz_tpu.utils.timing import StageTimer

    cfg = CodecConfig(
        mode="ec", error_bound=EB, container="v2", ids_codec="device",
        verify=True,
    )
    x_np = climate_formula(N)
    x_dev = jax.block_until_ready(jnp.asarray(x_np))

    blob = compress(x_np, config=cfg)  # warm-up: compiles every program
    y = decompress(blob)
    q = evaluate(x_np, y, EB, len(blob))
    compress(x_dev, config=cfg)

    t_c = _median_s(lambda: compress(x_np, config=cfg))
    t_d = _median_s(lambda: decompress(blob))
    t_c_dev = _median_s(lambda: compress(x_dev, config=cfg))

    mono = CodecConfig(
        mode="ec", error_bound=EB, container="v2", ids_codec="device",
        verify=True, segment_elems=0,
    )
    blob_m = compress(x_np, config=mono)
    decompress(blob_m)
    ct, dt = StageTimer(sync=True), StageTimer(sync=True)
    compress(x_np, config=mono, timer=ct)
    decompress(blob_m, timer=dt)

    gb = N * 4 / 1e9
    return {
        "gbps": 2 * gb / (t_c + t_d),
        "compress_s": t_c,
        "decompress_s": t_d,
        "compress_s_device_input": t_c_dev,
        "monolithic_compress_stages_s": dict(ct.stages),
        "monolithic_decompress_stages_s": dict(dt.stages),
        "ratio": q["ratio"],
        "psnr_db": q["psnr_db"],
        "max_rel_err": q["max_rel_err"],
        "bound_satisfied_full_array": q["bound_satisfied"],
    }


def bench_native() -> dict:
    from dctz_tpu import native
    from dctz_tpu.eval.datasets import climate_formula

    x = climate_formula(N)
    t_c = t_d = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        blob = native.compress(x, EB, "ec")
        t_c = min(t_c, time.perf_counter() - t0)
        t0 = time.perf_counter()
        native.decompress(blob)
        t_d = min(t_d, time.perf_counter() - t0)
    gb = x.nbytes / 1e9
    return {"gbps": 2 * gb / (t_c + t_d), "ratio": x.nbytes / len(blob)}


def main() -> None:
    import jax

    from dctz_tpu import backend, native
    from dctz_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    dev = backend.require_accelerator()
    card = gpu_name_and_power_limit()
    ours = bench_jax()
    base = bench_native() if native.available() else None
    result = {
        "metric": "compress+decompress throughput from a host array "
                  "(climate f32 128 MB, EC 1E-3, verify, pipelined default "
                  "path, median wall clock)",
        "value": ours["gbps"],
        "unit": "GB/s",
        "vs_baseline": ours["gbps"] / base["gbps"] if base else None,
        "detail": {
            "jax": ours,
            "native_cpu_baseline": base,
            "n_elements": N,
            "device": {
                "platform": dev.platform,
                "kind": dev.device_kind,
                "count": len(jax.devices()),
                "name_power_limit": card,
            },
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
