"""dct_precision="high": relaxed 3-pass ANALYSIS DCT (docs/numerics.md).

Only the forward transform relaxes — verify-repair and the decoder
reconstruct with the same HIGHEST IDCT either way, so cfg.verify keeps the
pointwise guarantee bit-for-bit intact. "high" is pinned to the explicit
DotAlgorithmPreset.BF16_BF16_F32_X3 (backend.dct_precision); these tests pin
the PLUMBING (config validation, every encode path accepting the knob) and
the guarantee. chip_smoke.py compiles the algorithm on the GPU."""

import io

import numpy as np
import pytest

import dctz_tpu
from dctz_tpu import stream
from dctz_tpu.config import CodecConfig


def _signal(n=1 << 17):
    rng = np.random.default_rng(7)
    return (
        np.sin(np.arange(n, dtype=np.float32) * 0.01) * 20
        + rng.standard_normal(n).astype(np.float32) * 0.05
    )


def test_config_validates():
    with pytest.raises(ValueError, match="dct_precision"):
        CodecConfig(dct_precision="bf16")


@pytest.mark.parametrize("mode", ["ec", "qt"])
@pytest.mark.parametrize("ids_codec", ["auto", "device"])
def test_high_roundtrip_verified(mode, ids_codec):
    x = _signal()
    cfg = CodecConfig(
        mode=mode, error_bound=1e-3, container="v2", ids_codec=ids_codec,
        verify=True, dct_precision="high", segment_elems=0,
    )
    y = dctz_tpu.decompress(dctz_tpu.compress(x, config=cfg))
    assert dctz_tpu.evaluate(x, y, 1e-3)["bound_satisfied"]


def test_high_fused_kernel_bf16x3_arm():
    """The pinned bf16x3 algorithm on the device-coded path: bound
    guaranteed, streams decodable, same container format as HIGHEST."""
    x = _signal(1 << 16)
    blobs = {}
    for prec in ("highest", "high"):
        cfg = CodecConfig(
            mode="ec", error_bound=1e-3, container="v2",
            ids_codec="device", verify=True, dct_precision=prec,
            segment_elems=0,
        )
        blobs[prec] = dctz_tpu.compress(x, config=cfg)
        y = dctz_tpu.decompress(blobs[prec])
        tol = 1e-3 * (x.max() - x.min())
        assert np.abs(y - x).max() <= tol, prec
    # same container format; the payload may differ at borderline bins
    assert blobs["high"][:8] == blobs["highest"][:8]


def test_high_segment_stream():
    x = _signal()
    cfg = CodecConfig(
        mode="ec", error_bound=1e-3, container="v2", verify=True,
        dct_precision="high", segment_elems=1 << 15,
    )
    blob = dctz_tpu.compress(x, config=cfg)
    assert blob[:4] == b"DTZS"
    y = dctz_tpu.decompress(blob)
    assert dctz_tpu.evaluate(x, y, 1e-3)["bound_satisfied"]


def test_high_sharded():
    from dctz_tpu import compress_sharded
    from dctz_tpu.parallel import sharding as sh

    x = _signal()
    cfg = CodecConfig(
        mode="ec", error_bound=1e-3, container="v2", verify=True,
        dct_precision="high",
    )
    y = dctz_tpu.decompress(
        compress_sharded(x, config=cfg, mesh=sh.make_mesh())
    )
    assert dctz_tpu.evaluate(x, y, 1e-3)["bound_satisfied"]


def test_default_streams_unchanged():
    """dct_precision defaults to "highest": containers byte-identical to a
    config that never heard of the knob (golden/parity safety)."""
    x = _signal()
    a = dctz_tpu.compress(
        x, config=CodecConfig(error_bound=1e-3, container="v2",
                              segment_elems=0)
    )
    b = dctz_tpu.compress(
        x, config=CodecConfig(error_bound=1e-3, container="v2",
                              segment_elems=0, dct_precision="highest")
    )
    assert a == b
