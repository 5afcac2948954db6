"""DCTZ-TPU: an error-bounded lossy compressor for floating-point scientific
data, in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of swson/DCTZ: blockwise
orthonormal DCT-II + adaptive 255-bin quantization with exact-outlier (EC)
or quantizer-table (QT) handling, zlib entropy coding, and a self-describing
container — redesigned as static-shape tensor algebra that runs on the CPU
or NVIDIA GPUs and scales over a device mesh.

Quick start:
    import numpy as np, dctz_tpu
    x = np.random.randn(1_000_000).astype(np.float32)
    blob = dctz_tpu.compress(x, error_bound=1e-3, mode="ec")
    y = dctz_tpu.decompress(blob)
"""

def _tune_malloc() -> None:
    """Keep multi-MB host buffers on the glibc heap instead of per-call
    mmap/munmap: the container stages allocate and free 10-20 MB byte
    strings per 128 MB array, and fresh-mapped pages fault at wildly
    variable cost (measured 16 ms median -> 2.9 ms for a 16 MB join on the
    earlier 4-core development VM). Opt out with DCTZ_NO_MALLOPT=1."""
    import ctypes
    import os
    import sys

    if os.environ.get("DCTZ_NO_MALLOPT") or not sys.platform.startswith(
        "linux"
    ):
        return
    try:
        libc = ctypes.CDLL("libc.so.6")
        libc.mallopt(-3, 1 << 30)  # M_MMAP_THRESHOLD
        libc.mallopt(-1, 1 << 30)  # M_TRIM_THRESHOLD
    except OSError:  # pragma: no cover - non-glibc linux
        pass


_tune_malloc()

from .api import compress, compress_sharded, decompress, decompress_sharded
from .config import CodecConfig
from .core.constants import BLK_SZ, NBINS, VERSION
from .utils.metrics import evaluate

__version__ = VERSION

__all__ = [
    "compress",
    "decompress",
    "compress_sharded",
    "decompress_sharded",
    "CodecConfig",
    "evaluate",
    "BLK_SZ",
    "NBINS",
    "VERSION",
]
