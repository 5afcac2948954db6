"""Randomized configuration-space soak (trimmed CI version of the 400-trial
sweep that validated round 1 — shapes x dtypes x modes x containers x
filters x codecs, with cross-engine decode checks)."""

import numpy as np
import pytest

import dctz_tpu
from dctz_tpu import native
from dctz_tpu.config import CodecConfig


@pytest.mark.parametrize("seed", range(4))
def test_random_config_roundtrips(seed):
    rng = np.random.default_rng(1000 + seed)
    for _ in range(10):
        n = int(rng.integers(1, 50000))
        dtype = rng.choice([np.float32, np.float64])
        kind = int(rng.integers(0, 4))
        if kind == 0:
            x = rng.standard_normal(n) * 10.0 ** int(rng.integers(-6, 6))
        elif kind == 1:
            x = np.sin(np.linspace(0, int(rng.integers(1, 300)), n)) * 100
        elif kind == 2:
            x = np.full(n, float(rng.standard_normal()) * 42)
        else:
            x = rng.standard_normal(n) * 0.01
            x[rng.random(n) < 0.01] *= 1e4
        x = x.astype(dtype)
        eb = float(rng.choice([1e-3, 1e-4, 3.3e-4]))
        cfg = CodecConfig(
            mode=str(rng.choice(["ec", "qt"])),
            error_bound=eb,
            container=str(rng.choice(["v1", "v2"])),
            chunk_bytes=int(rng.choice([4096, 1 << 16])),
            shuffle=bool(rng.integers(0, 2)),
            ids4=bool(rng.integers(0, 2)),
            ids_codec=str(rng.choice(["auto", "deflate"])),
        )
        blob = dctz_tpu.compress(x, config=cfg)
        y = dctz_tpu.decompress(blob)
        assert y.shape == x.shape and y.dtype == x.dtype
        span = float(x.max() - x.min())
        if span > 0:
            rel = float(np.abs(x - y).max()) / span
            # QT deliberately loosens outlier precision (docs/numerics.md);
            # flag only gross violations
            assert rel <= max(eb * 20, 1e-3), (rel, cfg)
        if cfg.container == "v1" and native.available():
            y2 = native.decompress(blob)
            np.testing.assert_allclose(
                y, y2, rtol=1e-5, atol=1e-7 * max(1.0, float(np.abs(x).max()))
            )


@pytest.mark.parametrize("seed", range(2))
def test_random_config_roundtrips_fused(seed):
    """Knob soak on the device id codec (ids_codec="device"): verify mode,
    monolithic and pipelined segment streams."""
    rng = np.random.default_rng(7000 + seed)
    for _ in range(5):
        n = int(rng.integers(1000, 200000))
        kind = int(rng.integers(0, 3))
        if kind == 0:
            x = rng.standard_normal(n) * 10.0
        elif kind == 1:
            x = np.sin(np.linspace(0, 80, n)) * 100
        else:
            x = rng.standard_normal(n) * 0.01
            x[rng.random(n) < 0.01] *= 1e4
        x = x.astype(np.float32)
        eb = float(rng.choice([1e-3, 1e-4]))
        cfg = CodecConfig(
            mode=str(rng.choice(["ec", "qt"])),
            error_bound=eb,
            container="v2",
            ids_codec="device",
            verify=bool(rng.integers(0, 2)),
            segment_elems=(
                int(rng.choice([1 << 15, 1 << 16]))
                if rng.integers(0, 2)
                else None
            ),
        )
        blob = dctz_tpu.compress(x, config=cfg)
        y = dctz_tpu.decompress(blob)
        assert y.shape == x.shape and y.dtype == x.dtype
        span = float(x.max() - x.min())
        if span > 0:
            rel = float(np.abs(x - y).max()) / span
            if cfg.verify and cfg.mode == "ec":
                assert rel <= eb * 1.001, (rel, cfg)
            else:
                # QT verify has a documented qtable precision floor
                assert rel <= max(eb * 20, 1e-3), (rel, cfg)

