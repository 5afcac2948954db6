"""DC-delta coding (container.Header.dcd, round 5): lossless u32 deltas
of the DC stream, gated by cfg.dc_delta (default OFF — measured a wash on
the available workloads) — every decode path must
invert it exactly."""

import io

import numpy as np
import pytest

import dctz_tpu
from dctz_tpu import api, stream
from dctz_tpu.config import CodecConfig
from dctz_tpu.core import container as ct
from dctz_tpu.core import entropy


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    x = (
        np.cumsum(rng.standard_normal(n).astype(np.float32) * 0.01) * 5
        + np.sin(np.arange(n, dtype=np.float32) * 0.01) * 20
    ).astype(np.float32)
    x[::977] *= 12.0
    return x


def test_f32_delta_exact_roundtrip():
    rng = np.random.default_rng(1)
    for n in (1, 255, 256, 257, 4097):
        x = (rng.standard_normal(n) * rng.choice([1e-6, 1, 1e7], n)).astype(
            np.float32
        )
        x[rng.random(n) < 0.1] *= -1
        y = entropy.f32_delta_inv(entropy.f32_delta(x))
        assert np.array_equal(x.view(np.uint32), y.view(np.uint32))


@pytest.mark.parametrize(
    "kw",
    [
        dict(mode="ec"),
        dict(mode="qt"),
        dict(mode="ec", ids_codec="device"),
        dict(mode="qt", ids_codec="device"),
    ],
)
def test_dcd_roundtrip_matches_plain(kw):
    """dcd containers decode to EXACTLY the same array as plain ones, the
    flag round-trips, and old (plain) containers still decode."""
    x = _data(1 << 16)
    base = dict(error_bound=1e-3, container="v2", segment_elems=0)
    z1 = dctz_tpu.compress(x, config=CodecConfig(**base, dc_delta=True, **kw))
    z0 = dctz_tpu.compress(x, config=CodecConfig(**base, **kw))
    h1, *_ = ct.parse_v2(z1)
    h0, *_ = ct.parse_v2(z0)
    assert h1.dcd and not h0.dcd
    np.testing.assert_array_equal(
        dctz_tpu.decompress(z1), dctz_tpu.decompress(z0)
    )


def test_dcd_range_decode():
    """Tile-range decodes of a dcd container invert the delta locally
    (restart interval == tile_b blocks)."""
    from dctz_tpu.ops import idpack

    x = _data(1 << 18, seed=3)
    cfg = CodecConfig(
        mode="ec", error_bound=1e-3, container="v2", ids_codec="device",
        segment_elems=0, dc_delta=True,
    )
    blob = dctz_tpu.compress(x, config=cfg)
    header, streams, qtable, _cb = ct.parse_v2(blob)
    assert header.dpk and header.dcd
    full = dctz_tpu.decompress(blob)
    n_stream, tile_b, cw = api._dpk_meta(header, streams)
    t = idpack.tiles_of(-(-n_stream // header.block_size), tile_b)
    cuts = sorted({0, t // 3, 2 * t // 3, t})
    y = np.concatenate([
        api._decompress_dpk_range(header, streams, qtable, a, b)
        for a, b in zip(cuts[:-1], cuts[1:])
    ])
    np.testing.assert_array_equal(y, full)


def test_dcd_stream_segments():
    x = _data(1 << 17, seed=4)
    cfg = CodecConfig(
        mode="ec", error_bound=1e-3, container="v2", dc_delta=True
    )
    buf = io.BytesIO()
    stream.compress_stream(x, buf, config=cfg, segment_elems=1 << 15)
    buf.seek(0)
    y = stream.decompress_stream_all(buf)
    mono = dctz_tpu.decompress(
        dctz_tpu.compress(
            x, config=CodecConfig(
                mode="ec", error_bound=1e-3, container="v2",
                segment_elems=0, dc_delta=True,
            )
        )
    )
    np.testing.assert_array_equal(y, mono)


def test_dcd_sharded_decode():
    from dctz_tpu.parallel import sharding as sh

    x = _data(8 * 256 * 64 * 2, seed=5)
    cfg = CodecConfig(
        mode="ec", error_bound=1e-3, container="v2", ids_codec="device",
        segment_elems=0, dc_delta=True,
    )
    blob = dctz_tpu.compress(x, config=cfg)
    h, *_ = ct.parse_v2(blob)
    assert h.dcd
    y = dctz_tpu.decompress_sharded(blob, mesh=sh.make_mesh())
    np.testing.assert_array_equal(y, dctz_tpu.decompress(blob))


def test_dcd_container_corruption_detected():
    """Sampled byte flips across a dcd container must never decode to
    silently wrong data: every flip either raises (crc/parse) or — for
    the rare crc-colliding-free header fields like the stored sf — still
    decodes SOMETHING rather than crashing the process."""
    x = _data(1 << 14, seed=8)
    cfg = CodecConfig(
        mode="ec", error_bound=1e-3, container="v2", ids_codec="device",
        segment_elems=0, dc_delta=True,
    )
    blob = bytes(dctz_tpu.compress(x, config=cfg))
    rng = np.random.default_rng(0)
    raised = 0
    for pos in rng.choice(len(blob), 64, replace=False):
        bad = bytearray(blob)
        bad[pos] ^= 0xA5
        try:
            dctz_tpu.decompress(bytes(bad))
        except Exception:
            raised += 1
    assert raised >= 48  # payload flips (the vast majority) must raise


def test_dcd_device_host_transforms_agree():
    """The device twins produce bit-identical transforms to the host ones
    (the plane-split encode uses the device version; host packers and the
    generic path use numpy)."""
    import jax.numpy as jnp

    x = _data(5000, seed=6)
    d_host = entropy.f32_delta(x)
    d_dev = np.asarray(api._f32_delta_dev(jnp.asarray(x)))
    assert np.array_equal(d_host.view(np.uint32), d_dev.view(np.uint32))
    i_host = entropy.f32_delta_inv(d_host)
    i_dev = np.asarray(api._f32_delta_inv_dev(jnp.asarray(d_host)))
    assert np.array_equal(i_host.view(np.uint32), i_dev.view(np.uint32))
    assert np.array_equal(i_host.view(np.uint32), x.view(np.uint32))
