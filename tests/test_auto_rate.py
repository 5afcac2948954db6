"""Auto-rate mode (cfg.rate="auto") and the fused-fallback warning."""

import warnings

import numpy as np
import pytest

import dctz_tpu
from dctz_tpu import api
from dctz_tpu.config import CodecConfig
from dctz_tpu.core import container as ct


def _smooth(n=1 << 16, seed=3):
    rng = np.random.default_rng(seed)
    freqs = np.fft.rfftfreq(n)
    spec = np.where(freqs > 0, freqs**-1.0, 0) * np.exp(
        2j * np.pi * rng.random(freqs.size)
    )
    x = np.fft.irfft(spec, n).astype(np.float32)
    return (x * (50 / np.abs(x).max())).astype(np.float32)


@pytest.mark.parametrize("eb", [1e-3, 1e-5])
def test_auto_rate_improves_ratio_and_keeps_bound(eb):
    x = _smooth()
    fixed = dctz_tpu.compress(
        x, config=CodecConfig(mode="ec", error_bound=eb, container="v2",
                              verify=True)
    )
    auto = dctz_tpu.compress(
        x, config=CodecConfig(mode="ec", error_bound=eb, container="v2",
                              rate="auto")
    )
    assert len(auto) < len(fixed)  # surplus fidelity converted into ratio
    y = dctz_tpu.decompress(auto)
    m = dctz_tpu.evaluate(x, y, eb, len(auto))
    assert m["bound_satisfied"], m
    # the chosen geometry is recorded in the header (decoder-visible)
    hdr, _s, _q, _cb = ct.parse_v2(auto)
    assert hdr.brsf > 1.0


def test_auto_rate_qt_composes_with_segments():
    """rate="auto" x QT x the pipelined segment path (round 5): the trial
    picks a brsf, the stream writer's global qtable pre-pass runs at that
    geometry, every frame carries it, and the bound holds."""
    import io

    from dctz_tpu import stream

    x = _smooth(1 << 16, seed=9)
    cfg = CodecConfig(
        mode="qt", error_bound=1e-3, container="v2", rate="auto",
        segment_elems=1 << 14,
    )
    blob = dctz_tpu.compress(x, config=cfg)
    assert blob[:4] == stream.MAGIC  # routed through the DTZS writer
    y = dctz_tpu.decompress(blob)
    m = dctz_tpu.evaluate(x, y, 1e-3, len(blob))
    assert m["bound_satisfied"], m
    # frames carry the chosen geometry AND the same global qtable
    raw = memoryview(blob)
    off = stream._HDR.size
    brsfs, tables = [], []
    while True:
        (flen,) = stream._FRAME.unpack_from(raw, off)
        if not flen:
            break
        hdr, _s, qtable, _cb = ct.parse_v2(
            raw[off + stream._FRAME.size : off + stream._FRAME.size + flen]
        )
        assert hdr.mode == "qt"
        brsfs.append(hdr.brsf)
        tables.append(qtable)
        off += stream._FRAME.size + flen
    assert len(set(brsfs)) == 1
    for t in tables[1:]:
        np.testing.assert_array_equal(t[1:], tables[0][1:])


def test_auto_rate_forces_verify_and_v2():
    x = _smooth(1 << 12)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        blob = dctz_tpu.compress(
            x, config=CodecConfig(mode="ec", error_bound=1e-3,
                                  container="v1", rate="auto")
        )
    assert any("rate='auto'" in str(x.message) for x in w)
    assert ct.detect_format(blob) == "v2"
    y = dctz_tpu.decompress(blob)
    assert dctz_tpu.evaluate(x, y, 1e-3)["bound_satisfied"]


def test_auto_rate_ladder_monotone_stop():
    """The ladder must early-stop once size turns upward — never scan the
    whole ladder on data where brsf=1 is already best (pure noise)."""
    calls = []
    orig = api.compress

    rng = np.random.default_rng(0)
    x = (rng.standard_normal(1 << 12) * 1e3).astype(np.float32)

    def spy(arr, *a, **kw):
        cfgp = kw.get("config")
        if cfgp is not None and cfgp.rate == "fixed":
            calls.append(cfgp.brsf)
        return orig(arr, *a, **kw)

    api.compress = spy
    try:
        b = api._auto_rate_brsf(x, x.size, CodecConfig(
            mode="ec", error_bound=1e-3, container="v2", rate="auto"))
    finally:
        api.compress = orig
    assert len(calls) < len(api.AUTO_RATE_LADDER)
    assert b >= 1.0


def test_rate_sample_is_block_aligned_and_spread():
    x = np.arange(1 << 23, dtype=np.float32)
    s = api._rate_sample(x, x.size, 64)
    assert s.size <= api._AUTO_SAMPLE_ELEMS
    assert s.size % 64 == 0
    # the sample must include material from the array's tail half
    assert float(s.max()) > x.size * 0.5
