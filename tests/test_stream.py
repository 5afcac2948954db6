"""Streamed/segmented container tests (multi-TB checkpoint story)."""

import io

import numpy as np
import pytest

import dctz_tpu
from dctz_tpu import stream
from dctz_tpu.config import CodecConfig


@pytest.mark.parametrize("mode", ["ec", "qt"])
def test_stream_roundtrip(mode):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(64 * 700 + 21) * 30
    buf = io.BytesIO()
    stream.compress_stream(x, buf, 1e-3, mode, segment_elems=64 * 100)
    buf.seek(0)
    y = stream.decompress_stream_all(buf)
    assert y.shape == x.shape
    assert dctz_tpu.evaluate(x, y, 1e-3)["bound_satisfied"]


def test_stream_matches_monolithic_reconstruction():
    """Fixed global sf + block-aligned segments => identical reconstruction
    to the single-shot codec."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal(64 * 512) * 5
    buf = io.BytesIO()
    stream.compress_stream(x, buf, 1e-4, "ec", segment_elems=64 * 128)
    buf.seek(0)
    y_stream = stream.decompress_stream_all(buf)
    y_mono = dctz_tpu.decompress(
        dctz_tpu.compress(x, config=CodecConfig(mode="ec", error_bound=1e-4, container="v2"))
    )
    np.testing.assert_array_equal(y_stream, y_mono)


def test_stream_segments_independently_decodable():
    rng = np.random.default_rng(2)
    x = rng.standard_normal(64 * 300).astype(np.float32)
    buf = io.BytesIO()
    stream.compress_stream(x, buf, 1e-3, "ec", segment_elems=64 * 100)
    buf.seek(0)
    segs = list(stream.decompress_stream(buf))
    assert len(segs) == 3
    np.testing.assert_array_equal(np.concatenate(segs).shape, x.shape)


@pytest.mark.parametrize("mode", ["ec", "qt"])
def test_stream_generic_segments_verify_bound(mode):
    """cfg.verify on the generic (non-DPK) segment path: each segment runs
    verify-repair against the GLOBAL tolerance (pre-round-4 it was silently
    ignored). sedov is the canonical pointwise-bound violator."""
    from dctz_tpu.eval.datasets import SUITES

    x = next(ds for ds in SUITES["msst19"] if ds.name == "sedov").load()
    eb = 1e-3
    # without verify the segmented encoding violates the bound (the bug)
    buf0 = io.BytesIO()
    stream.compress_stream(
        x, buf0, config=CodecConfig(mode=mode, error_bound=eb, container="v2"),
        segment_elems=1 << 16,
    )
    buf0.seek(0)
    y0 = stream.decompress_stream_all(buf0)
    assert not dctz_tpu.evaluate(x, y0, eb)["bound_satisfied"]

    buf = io.BytesIO()
    stream.compress_stream(
        x, buf,
        config=CodecConfig(mode=mode, error_bound=eb, container="v2", verify=True),
        segment_elems=1 << 16,
    )
    buf.seek(0)
    y = stream.decompress_stream_all(buf)
    assert dctz_tpu.evaluate(x, y, eb)["bound_satisfied"]


def test_stream_bad_magic():
    with pytest.raises(ValueError, match="not a DCTZ-TPU stream"):
        list(stream.decompress_stream(io.BytesIO(b"JUNK" + b"\0" * 12)))


def test_stream_dpk_fused_segments_roundtrip():
    """The DPK segment writer (one XLA program per segment: DCT + quantize
    + verify-repair + pack_ids_with_ac) + overlapped reader: bound holds,
    frames are DPK v2 containers, and the decode equals the monolithic
    device-coded encoding bit-for-bit (block-aligned input)."""
    import dataclasses

    from dctz_tpu.core import container as ct

    rng = np.random.default_rng(7)
    x = (np.sin(np.arange(1 << 18, dtype=np.float32) * 0.01) * 20
         + rng.standard_normal(1 << 18).astype(np.float32) * 0.05)
    cfg = CodecConfig(
        mode="ec", error_bound=1e-3, container="v2",
        ids_codec="device", verify=True,
    )
    buf = io.BytesIO()
    stream.compress_stream(x, buf, config=cfg, segment_elems=1 << 16)
    raw = buf.getvalue()
    # frames must be DPK v2 containers
    off = stream._HDR.size
    (flen,) = stream._FRAME.unpack_from(raw, off)
    hdr, _s, _q, _cb = ct.parse_v2(
        raw[off + stream._FRAME.size : off + stream._FRAME.size + flen]
    )
    assert hdr.dpk
    buf.seek(0)
    y = stream.decompress_stream_all(buf)
    tol = 1e-3 * (x.max() - x.min())
    assert y.shape == x.shape
    assert np.abs(y - x).max() <= tol

    y_mono = dctz_tpu.decompress(
        dctz_tpu.compress(x, config=dataclasses.replace(cfg, segment_elems=0))
    )
    np.testing.assert_array_equal(y, y_mono)


def test_stream_qt_matches_monolithic():
    """Streamed QT (round 5): the global qtable pre-pass makes segmented
    QT encoding monolithic-identical — the decoded array is bit-equal to
    the single-shot QT codec's (generic/XLA path)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal(64 * 512) * 5
    x[::971] *= 40.0  # escapes in several positions -> nontrivial qtable
    cfg = CodecConfig(mode="qt", error_bound=1e-4, container="v2")
    buf = io.BytesIO()
    stream.compress_stream(x, buf, config=cfg, segment_elems=64 * 128)
    buf.seek(0)
    y_stream = stream.decompress_stream_all(buf)
    y_mono = dctz_tpu.decompress(dctz_tpu.compress(x, config=cfg))
    np.testing.assert_array_equal(y_stream, y_mono)

    # every frame stores the GLOBAL table (slots >= 1; slot 0 is the
    # frame's own last-block DC, never read by the decoder)
    from dctz_tpu.core import container as ct

    raw = buf.getvalue()
    off = stream._HDR.size
    tables = []
    while True:
        (flen,) = stream._FRAME.unpack_from(raw, off)
        if not flen:
            break
        hdr, _s, qtable, _cb = ct.parse_v2(
            raw[off + stream._FRAME.size : off + stream._FRAME.size + flen]
        )
        assert hdr.mode == "qt"
        tables.append(qtable)
        off += stream._FRAME.size + flen
    assert len(tables) == 4
    for t in tables[1:]:
        np.testing.assert_array_equal(t[1:], tables[0][1:])


def test_stream_dpk_qt_fused_segments_roundtrip():
    """QT on the pipelined DPK segment path: frames are QT DPK v2
    containers sharing the global qtable, and the unaligned tail segment
    (zero-padded to the 1024 quantum) holds the bound."""
    from dctz_tpu.core import container as ct

    rng = np.random.default_rng(9)
    n = (1 << 17) + 1025  # unaligned: the tail segment pads to 1024
    x = (np.sin(np.arange(n, dtype=np.float32) * 0.01) * 20
         + rng.standard_normal(n).astype(np.float32) * 0.05)
    x[::977] *= 30.0
    cfg = CodecConfig(
        mode="qt", error_bound=1e-3, container="v2",
        ids_codec="device", verify=True,
    )
    buf = io.BytesIO()
    stream.compress_stream(x, buf, config=cfg, segment_elems=1 << 16)
    raw = buf.getvalue()
    off = stream._HDR.size
    tables = []
    while True:
        (flen,) = stream._FRAME.unpack_from(raw, off)
        if not flen:
            break
        hdr, _s, qt, _cb = ct.parse_v2(
            raw[off + stream._FRAME.size : off + stream._FRAME.size + flen]
        )
        assert hdr.dpk and hdr.mode == "qt" and qt is not None
        tables.append(qt)
        off += stream._FRAME.size + flen
    assert len(tables) == 3
    for t in tables[1:]:
        np.testing.assert_array_equal(t[1:], tables[0][1:])
    # slot 0 = the tail segment's last REAL block DC, not a zero pad
    # block's (regression: indexing the padded dc array)
    assert tables[-1][0] != 0.0
    buf.seek(0)
    y = stream.decompress_stream_all(buf)
    tol = 1e-3 * (x.max() - x.min())
    assert np.abs(y - x).max() <= tol


def test_segment_dpk_plane_split_engages():
    """The device byte-plane split must activate on the pipelined DPK
    segments for the DEFAULT config (regression: deciding on the
    _device_cfg-normalized config silently disabled it — shuffle=False)."""
    from dctz_tpu.api import _device_cfg

    cfg = CodecConfig(
        mode="ec", error_bound=1e-3, container="v2", ids_codec="device",
    )
    seg = np.sin(np.arange(1 << 12, dtype=np.float32)) * 5
    outs, planes, n_pad, _qt = stream._encode_segment_dpk(
        seg, 8.0, 1e-2, _device_cfg(cfg), cfg
    )
    assert planes is not None
    assert planes[0].shape[0] == 4 and planes[0].dtype == np.uint8


def test_compress_segment_elems_routes_to_stream():
    """cfg.segment_elems pipelines the monolithic compress() into a DTZS
    stream; decompress() auto-detects and round-trips."""
    x = np.sin(np.arange(1 << 18, dtype=np.float32) * 0.003) * 11
    cfg = CodecConfig(
        mode="ec", error_bound=1e-3, container="v2",
        ids_codec="device", verify=True, segment_elems=1 << 16,
    )
    blob = dctz_tpu.compress(x, config=cfg)
    assert blob[:4] == b"DTZS"
    y = dctz_tpu.decompress(blob)
    tol = 1e-3 * (x.max() - x.min())
    assert np.abs(y - x).max() <= tol


def test_auto_segment_resolution():
    """segment_elems='auto' (the default) pipelines large v2 arrays (EC
    and, as of round 5, QT via the global qtable pre-pass) and stays
    monolithic for v1 and small inputs."""
    from dctz_tpu import api

    auto = CodecConfig(container="v2")
    assert auto.segment_elems == "auto"
    assert (
        api._resolve_segment(auto, stream.AUTO_THRESHOLD)
        == stream.DEFAULT_SEGMENT
    )
    assert api._resolve_segment(auto, stream.AUTO_THRESHOLD - 1) is None
    v1 = CodecConfig(container="v1")
    assert api._resolve_segment(v1, stream.AUTO_THRESHOLD) is None
    qt = CodecConfig(container="v2", mode="qt")
    assert (
        api._resolve_segment(qt, stream.AUTO_THRESHOLD)
        == stream.DEFAULT_SEGMENT
    )
    off = CodecConfig(container="v2", segment_elems=0)
    assert api._resolve_segment(off, stream.AUTO_THRESHOLD) is None
    explicit = CodecConfig(container="v2", segment_elems=1 << 16)
    assert api._resolve_segment(explicit, 1 << 17) == 1 << 16
    assert api._resolve_segment(explicit, (1 << 17) - 1) is None


def test_compress_auto_pipelines_large_arrays(monkeypatch):
    """The default config auto-routes a large v2 EC array through the DTZS
    pipeline; decompress() restores it into a single preallocated buffer."""
    monkeypatch.setattr(stream, "AUTO_THRESHOLD", 1 << 17)
    monkeypatch.setattr(stream, "DEFAULT_SEGMENT", 1 << 16)
    x = np.sin(np.arange(1 << 17, dtype=np.float32) * 0.003) * 11
    cfg = CodecConfig(mode="ec", error_bound=1e-3, container="v2")
    blob = dctz_tpu.compress(x, config=cfg)
    assert blob[:4] == b"DTZS"
    y = dctz_tpu.decompress(blob)
    tol = 1e-3 * (x.max() - x.min())
    assert np.abs(y - x).max() <= tol
    # memoryview input also decodes without a copy of the blob
    y2 = dctz_tpu.decompress(memoryview(blob))
    np.testing.assert_array_equal(y, y2)


def test_decompress_sharded_handles_dtzs():
    """decompress_sharded must restore the DTZS streams that the DEFAULT
    compress() path emits for large arrays (frame-wise sharded decode)."""
    import jax

    from dctz_tpu.api import decompress_sharded
    from dctz_tpu.parallel import sharding as sh

    mesh = sh.make_mesh(jax.devices()[:8])
    x = np.sin(np.arange(64 * 800, dtype=np.float32) * 0.01) * 25
    buf = io.BytesIO()
    stream.compress_stream(x, buf, 1e-3, "ec", segment_elems=64 * 300)
    blob = buf.getvalue()
    y = decompress_sharded(blob, mesh=mesh)
    np.testing.assert_array_equal(y, dctz_tpu.decompress(blob))
    assert dctz_tpu.evaluate(x, y, 1e-3)["bound_satisfied"]


def test_stream_device_resident_input_matches_numpy_path():
    """A jax.Array input reduces its stats ON DEVICE and streams HBM slices;
    the reconstruction matches the numpy two-pass path exactly."""
    import jax.numpy as jnp

    x = (np.sin(np.arange(64 * 400, dtype=np.float32) * 0.01) * 25).astype(
        np.float32
    )
    cfg = CodecConfig(mode="ec", error_bound=1e-3, container="v2")
    b_np, b_dev = io.BytesIO(), io.BytesIO()
    stream.compress_stream(x, b_np, config=cfg, segment_elems=64 * 100)
    stream.compress_stream(
        jnp.asarray(x), b_dev, config=cfg, segment_elems=64 * 100
    )
    b_np.seek(0)
    b_dev.seek(0)
    y_np = stream.decompress_stream_all(b_np)
    y_dev = stream.decompress_stream_all(b_dev)
    np.testing.assert_array_equal(y_np, y_dev)
    assert dctz_tpu.evaluate(x, y_dev, 1e-3)["bound_satisfied"]


def test_stream_generic_path_retries_on_ac_overflow():
    """Segments whose escapes are dense must not drop values: the host-coded
    segments compact into a full-length buffer, and the device-coded (DPK)
    segments retry at full chunk width when a chunk's exceptions exceed
    the default capacity."""
    from dctz_tpu.ops import idpack

    rng = np.random.default_rng(11)
    # dense escapes: wild data at a tight bound escapes nearly every coef
    x = (rng.standard_normal(64 * 256) * 1e4).astype(np.float32)
    tol = 1e-3 * (x.max() - x.min()) * 1.01
    for ids_codec in ("auto", "device"):
        cfg = CodecConfig(error_bound=1e-3, container="v2", ids_codec=ids_codec)
        buf = io.BytesIO()
        stream.compress_stream(x, buf, config=cfg, segment_elems=64 * 128)
        buf.seek(0)
        y = stream.decompress_stream_all(buf)
        assert np.abs(y - x).max() <= tol, ids_codec
    # the dense case really overflows the default exception capacity
    _ids, _pk, _exc, counts, ovf = idpack.pack_ids(
        np.full((128, 64), 255, np.uint8), 64 * 128, idpack.B_DEFAULT,
        idpack.CAPE,
    )
    assert bool(ovf) and int(np.max(counts)) > idpack.CAPE


def test_stream_restore_memory_bounded():
    """decompress_stream_all allocates the output once: peak traced
    allocations stay ~ output + O(segment), not 2x the array."""
    import tracemalloc

    x = np.sin(np.arange(1 << 20, dtype=np.float32) * 0.001) * 7
    cfg = CodecConfig(mode="ec", error_bound=1e-3, container="v2")
    buf = io.BytesIO()
    stream.compress_stream(x, buf, config=cfg, segment_elems=1 << 17)
    raw = buf.getvalue()
    # warm compiles/pools outside the trace
    _ = stream.decompress_stream_all(stream.MemReader(raw))
    tracemalloc.start()
    base, _ = tracemalloc.get_traced_memory()
    y = stream.decompress_stream_all(stream.MemReader(raw))
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    np.testing.assert_array_equal(y.shape, x.shape)
    # output is 4 MB; 8 segments of 0.5 MB each. The old list+concatenate
    # held >= 8 MB of parts; require peak-above-baseline < 1.75x output.
    assert peak - base < int(x.nbytes * 1.75), (peak, base, x.nbytes)


def test_stream_truncated_raises():
    rng = np.random.default_rng(4)
    x = rng.standard_normal(64 * 200).astype(np.float32)
    buf = io.BytesIO()
    stream.compress_stream(x, buf, 1e-3, "ec", segment_elems=64 * 100)
    raw = buf.getvalue()
    with pytest.raises(ValueError, match="truncated stream"):
        list(stream.decompress_stream(io.BytesIO(raw[: len(raw) // 2])))


def test_dump_tool_dtzs(tmp_path, capsys):
    from dctz_tpu.tools import dctz_dump

    x = np.sin(np.arange(64 * 300, dtype=np.float32) * 0.01) * 9
    buf = io.BytesIO()
    stream.compress_stream(x, buf, 1e-3, "ec", segment_elems=64 * 100)
    p = tmp_path / "s.dtzs"
    p.write_bytes(buf.getvalue())
    assert dctz_dump.main([str(p)]) == 0
    out = capsys.readouterr().out
    assert '"dtzs-stream"' in out and '"frames"' in out
