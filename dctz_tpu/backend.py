"""Device-path policy: every backend-dependent choice of the codec, in one place.

The codec runs one device path on every JAX backend it supports (the CPU and
NVIDIA GPUs): the XLA chain of api._encode_device / _decode_device /
_decode_device_dpk and ops/idpack.py. The choices that remain are made here,
and callers ask this module instead of testing the platform themselves.

One layout choice is fixed for every backend from a measurement on the
H100: every decoder places escaped AC values from per-chunk rows with a
one-hot contraction (quantize.decode), not by a gather from the global
stream. Inside the DPK decode program the global gather, indexed by a
prefix sum, took 10 s per 2^20 elements on the card, against 0.85 ms for
the chunked rows (NVIDIA H100 80GB HBM3, 700 W).
"""

from __future__ import annotations

import jax

from .config import CodecConfig

#: dct_precision -> the precision argument of the analysis DCT matmul.
#: "highest" is true float32 (no TF32 on a GPU). "high" pins the explicit
#: three-pass bf16 algorithm (~2^-16 relative per product): Precision.HIGH
#: would let XLA:GPU pick TF32, ~2^-11 (docs/numerics.md).
_DCT_PRECISION = {
    "highest": jax.lax.Precision.HIGHEST,
    "high": jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3,
}


def require_accelerator() -> jax.Device:
    """The first accelerator device; raises when JAX found none.

    Measurement and smoke scripts call this so that they fail instead of
    reporting CPU numbers under a device's name."""
    dev = jax.devices()[0]
    if dev.platform == "cpu":
        raise RuntimeError(
            "no accelerator: JAX's default backend is the CPU "
            f"({jax.devices()})"
        )
    return dev


def device_ids(cfg: CodecConfig) -> bool:
    """True when the bin-index stream is coded on the device (the DPK
    container, ops/idpack.py). ids_codec="auto" keeps the host coder
    (IDS4 nibbles + native rANS, else deflate) on every backend; "device"
    opts in, for v2 containers only."""
    return cfg.container == "v2" and cfg.ids_codec == "device"


def dct_precision(name: str):
    """Precision argument for the analysis DCT (CodecConfig.dct_precision).
    Every other matmul of the codec runs at Precision.HIGHEST."""
    return _DCT_PRECISION[name]
