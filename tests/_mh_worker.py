"""Worker process for the real multi-process multihost test.

Usage: python _mh_worker.py <coordinator> <nproc> <pid> <n_total> <mode> <out>

Each process owns 2 virtual CPU devices, joins the jax.distributed cluster,
compresses its host_slice of a deterministic array, and writes its part of
the global DTZS stream to <out>. The parent test concatenates the parts and
round-trips them in a separate single process.
"""

import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

# override (don't append): the parent pytest process exports its own
# 8-device XLA_FLAGS, and each worker must own exactly 2 virtual devices
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

import jax  # noqa: E402

# the tests run on the CPU backend; steer to it before first use
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402


def make_data(n: int) -> np.ndarray:
    t = np.linspace(0, 40, n)
    x = np.sin(t) * 25 + np.sin(t * 17.3) * 2
    spikes = np.arange(n) % 997 == 0
    return np.where(spikes, x * 9, x).astype(np.float64)


def main() -> None:
    coordinator, nproc, pid, n_total, mode, out_path = sys.argv[1:7]
    ids_codec = sys.argv[7] if len(sys.argv) > 7 else "auto"
    stream_path = sys.argv[8] if len(sys.argv) > 8 else None
    nproc, pid, n_total = int(nproc), int(pid), int(n_total)

    jax.distributed.initialize(
        coordinator_address=coordinator, num_processes=nproc, process_id=pid
    )
    assert jax.process_count() == nproc
    assert jax.device_count() == 2 * nproc

    from dctz_tpu.config import CodecConfig
    from dctz_tpu.ops import idpack
    from dctz_tpu.parallel import multihost as mh

    if mode == "restore":
        # distributed restore: decode ONLY this host's frames of the stream
        res = mh.decompress_multihost(
            pathlib.Path(stream_path).read_bytes()
        )
        np.savez(
            out_path,
            data=res.data,
            start=res.start,
            frames=np.asarray(res.frames, np.int64),
        )
        return

    quantum = idpack.B_DEFAULT if ids_codec == "device" else 1
    lo, hi = mh.host_slice(n_total, quantum_blocks=quantum)
    x = make_data(n_total)
    local = x[lo:min(hi, n_total)]  # last host passes only real elements

    cfg = CodecConfig(
        mode=mode,
        error_bound=1e-3,
        container="v2",
        verify=True,
        ids_codec=ids_codec,
    )
    part = mh.compress_multihost(local, n_total, config=cfg)
    with open(out_path, "wb") as f:
        f.write(part)


if __name__ == "__main__":
    main()
