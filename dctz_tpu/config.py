"""Runtime configuration for the DCTZ-TPU codec.

The reference selects modes at compile time (-DUSE_QTABLE / -DUSE_TRUNCATE,
reference: Makefile:12-24) and bakes tunables into dctz.h. Here everything is
one runtime dataclass: a single library covers all four reference binaries
(dctz-ec-test / dctz-qt-test and their Z-Checker variants).
"""

from __future__ import annotations

import dataclasses
from typing import Literal

from .core import constants as C

Mode = Literal["ec", "qt"]


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Full codec configuration.

    Attributes:
      mode: "ec" saves out-of-range AC coefficients verbatim (reference
        dctz-comp-lib.c:534-541); "qt" renormalizes them through a per-position
        quantizer table first (dctz-comp-lib.c:471-533).
      error_bound: absolute error bound in the DCT domain of the scaled data.
        Must be >= EB_MIN (dctz-comp-lib.c:135-138).
      truncate: store DC and AC_exact streams as float32 even for float64 data
        (reference USE_TRUNCATE, always on in shipped binaries: Makefile:13,17).
      block_size / nbins / brsf / sf_adj: geometry constants; defaults match
        the reference build (dctz.h:28-30,65-66).
      zlib_level: deflate level for the entropy stage; the reference uses
        Z_DEFAULT_COMPRESSION == 6 (dctz-comp-lib.c:643).
      ids_zlib_level: optional separate level for the (dominant) bin-index
        stream in v2 containers; level 4 is ~3x faster than 6 for ~8% of
        that stream's ratio — the shuffle filter's gains typically cover it.
      ids4: nibble-pack the bin-index stream (v2 only): ids <= 14 take 4
        bits, the rest escape to an exception byte stream. Measured: ~13%
        smaller ids section AND ~4x faster deflate (HUFFMAN_ONLY suffices
        on the packed stream).
      ids_codec: entropy codec for the bin-index stream (v2 containers).
        "auto" uses the host coder on every backend (backend.device_ids):
        the native static rANS (cpp/rans.cpp) on the ids4 nibbles when the
        native library is built, else deflate. "device" codes the stream
        ON THE DEVICE (ops/idpack.py: transposed per-position patched
        fixed-width packing) so the host only slices/concatenates; it was
        measured ~20% smaller than rANS on climate data. Note: on small
        arrays (<~1 MB) per-chunk/table overheads can outweigh the gains —
        v1/deflate may compress better there.
      container: "v1" emits the reference-compatible single-segment container
        (56-byte C struct header, dctz.h:96-119); "v2" emits the chunked
        container that supports parallel entropy coding and sharded
        multi-host writes.
      shuffle: byte-shuffle the float DC/AC streams before deflate (v2
        containers only — measured +61% DC ratio and ~2x deflate speed);
        v1 keeps the reference's raw layout.
      chunk_bytes: uncompressed chunk size for v2 parallel deflate (1 MiB
        default: finer chunks balance the thread pool at <0.2% ratio cost;
        measured +12% throughput over 4 MiB on the earlier 4-core
        development host).
      internal_dtype: "auto" runs the transform in the input dtype (float64
        needs jax x64 enabled). "float32" forces the single-precision
        device path for float64 input (the streams are float32 under
        truncate anyway; the added transform-rounding term is ~1e-6
        absolute in the scaled domain — budget in docs/numerics.md).
      float_codec: coding of the DC/AC float streams in v2 containers.
        "plane" (default) splits the shuffled stream into byte planes and
        codes each by its cheapest method (raw for the near-random low
        mantissa planes, chunked deflate for the exponent/sign planes):
        equal ratio to whole-stream shuffle+deflate within ~0.3% at ~3x the
        speed both ways (measured on the bench DC/AC streams). "deflate"
        keeps the round-1 whole-stream shuffle+deflate sections.
      dpk_host_codec: optional host second stage over the device-packed id
        section (ids_codec="device" only). "none" ships the packed bytes
        verbatim (maximum throughput: the host only concatenates);
        "zstd" runs chunk-parallel zstd-1 over them — measured ~20% off
        the packed section (container ratio 9.4 -> 10.6 on the bench
        workload) for ~0.8 ms/MB each way, strictly dominating the older
        modes (requires the `zstandard` package; falls back to "none");
        "deflate" runs chunk-parallel level-1 deflate (~2x smaller packed
        section on smooth data at ~7 ms/MB); "rans" is the native-rANS
        light ratio mode (~12% off at ~5x deflate's speed). Decode
        reverses the chosen codec before the device unpack.
      host_codec: entropy backend for v2 side sections and PLC planes.
        "auto" (default) uses chunk-parallel zstd when the `zstandard`
        package is importable — measured 2-10x faster than the
        zlib/rANS stage at equal-or-better ratio on every stream of the
        earlier development host; "zlib" forces the pre-zstd codec set for
        byte parity with older fixtures. v1 containers always use zlib
        (reference interop).
      verify: device-side verify-and-repair (ops/repair.py): reconstruct the
        array inside the encode program exactly as the decoder will, and
        force-escape the coefficients of any block whose pointwise error
        exceeds eb * value_range — the check the reference ships disabled
        (util.c:96-102). Guarantees 100% pointwise bound satisfaction (up to
        documented f32-truncation floors) at <1% typical ratio cost and
        roughly 2x the device-stage (NOT end-to-end) compress time. Off by
        default to preserve byte parity with the reference streams; the eval
        harness enables it.
    """

    mode: Mode = "ec"
    error_bound: float = 1e-3
    truncate: bool = True
    block_size: int = C.BLK_SZ
    nbins: int = C.NBINS
    brsf: float = C.BRSF
    sf_adj: int = C.SF_ADJ_AMT
    zlib_level: int = 6
    ids_zlib_level: int | None = None
    container: Literal["v1", "v2"] = "v1"
    shuffle: bool = True
    ids4: bool = True
    ids_codec: Literal["auto", "deflate", "rans", "device"] = "auto"
    float_codec: Literal["plane", "deflate"] = "plane"
    #: delta-code the DC stream of v2 float32 containers before the section
    #: codec (order-preserving u32 deltas, restart every 256 blocks —
    #: entropy.f32_delta; exactly lossless, flagged in the header,
    #: Header.dcd, older containers decode unchanged). Default OFF: a
    #: round-5 MEASURED negative — under the per-plane codec the raw DC
    #: planes already carry long-range structure zstd exploits, and
    #: delta/xor prediction moved every measured workload by at most
    #: -2%..+2% (only brown noise gained 6-9%; a ratio measurement).
    #: The reference deflates DC raw (dctz-comp-lib.c:669-703).
    dc_delta: bool = False
    dpk_host_codec: Literal["none", "deflate", "rans", "zstd"] = "none"
    host_codec: Literal["auto", "zlib"] = "auto"
    chunk_bytes: int = 1 << 20
    internal_dtype: Literal["auto", "float32"] = "auto"
    verify: bool = False
    #: rate selection. "fixed" uses cfg.brsf as given (reference semantics:
    #: bin width = 2*eb*brsf, compile-time BRSF=1). "auto" converts surplus
    #: fidelity into ratio: the encoder picks the widest bin geometry
    #: (brsf on the container's 2**(k/8) grid) whose compressed size is
    #: smallest, while verify-repair — forced on — keeps the POINTWISE
    #: bound guaranteed at eb exactly as for brsf=1 (escapes absorb what
    #: wider bins can no longer represent). At matched bound this recovers
    #: the ~50 dB of fidelity the fixed geometry over-delivers
    #: (BASELINE.md rate-distortion tables). v2 containers only.
    rate: Literal["fixed", "auto"] = "fixed"
    #: segment the monolithic compress() into a pipelined DTZS stream when
    #: the input exceeds 2x this element count (device encode of segment k+1
    #: overlaps host packing of segment k; stream.py). "auto" (default)
    #: engages the pipeline for v2 containers above stream.AUTO_THRESHOLD
    #: elements — the host stage then overlaps device compute instead of
    #: serializing after it (VERDICT round-3 #1). None/0 = always
    #: monolithic; an int = explicit segment size.
    segment_elems: int | Literal["auto"] | None = "auto"
    #: Matmul precision of the ANALYSIS (forward) DCT on the encode path
    #: (backend.dct_precision). "highest" (default) = true float32,
    #: byte-parity with the reference streams. "high" = the explicit
    #: three-pass bf16 algorithm (DotAlgorithmPreset.BF16_BF16_F32_X3) at
    #: ~2^-16 relative rounding per product, which only shifts WHICH bin a
    #: borderline coefficient lands in: the verify-repair pass and the
    #: decoder reconstruct with the same HIGHEST IDCT either way, so
    #: cfg.verify still guarantees the pointwise bound exactly
    #: (docs/numerics.md). Recommended with verify=True; streams are NOT
    #: byte-identical to "highest" ones (same format, different borderline
    #: bins).
    dct_precision: Literal["highest", "high"] = "highest"

    def __post_init__(self) -> None:
        if self.mode not in ("ec", "qt"):
            raise ValueError(f"mode must be 'ec' or 'qt', got {self.mode!r}")
        if self.dct_precision not in ("highest", "high"):
            raise ValueError(
                f"dct_precision must be 'highest' or 'high', got "
                f"{self.dct_precision!r}"
            )
        if self.error_bound < C.EB_MIN:
            # Reference: "ERROR BOUND is not acceptable" (dctz-comp-lib.c:136).
            raise ValueError(
                f"error_bound {self.error_bound} below minimum {C.EB_MIN}"
            )
        if self.block_size < 2:
            raise ValueError("block_size must be >= 2")
        if not 1 <= self.nbins <= 255:
            raise ValueError("nbins must fit an 8-bit index with one escape code")

    @property
    def qt_factor(self) -> float:
        return C.qt_factor(self.nbins)

    @property
    def bin_width(self) -> float:
        return self.error_bound * 2.0 * self.brsf

    @property
    def range_max(self) -> float:
        # (2*(nbins//2)+1) * eb * brsf == nbins*eb for odd nbins
        # (dctz-comp-lib.c:271-281; decoder uses eb*NBINS, dctz-decomp-lib.c:373).
        half = self.nbins // 2
        return (half * 2 + 1) * (self.error_bound * self.brsf)

    @property
    def range_min(self) -> float:
        return -self.range_max
