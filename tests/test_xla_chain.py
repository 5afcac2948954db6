"""The XLA device chain against plain NumPy / SciPy references.

These are the programs every backend runs (the CPU here, NVIDIA GPUs in
production): the DPK id coder (idpack.pack_ids / pack_ids_with_ac /
unpack_ids), the DPK decode program (api._decode_device_dpk) and the
encode's bin ids (api._encode_device). The references are independent:
SciPy's orthonormal DCT, the closed-form binning of binning.py's docstring,
and NumPy loops for the stream layouts."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.fft

from dctz_tpu import api
from dctz_tpu.config import CodecConfig
from dctz_tpu.core import entropy
from dctz_tpu.core import quantize as qz
from dctz_tpu.core import transform
from dctz_tpu.core.constants import ESCAPE
from dctz_tpu.ops import idpack

B = idpack.B_DEFAULT


def _ids_grid(rng, nblk, heavy):
    """Bin-id grids shaped like real encodes: small ids at high
    frequencies, ESCAPE at DC, escape-heavy variants with many 255s."""
    bs = 64
    scale = np.linspace(12.0, 0.3, bs)[None, :]
    ids = np.abs(rng.standard_normal((nblk, bs)) * scale).astype(np.int64)
    if heavy:
        ids[rng.random((nblk, bs)) < 0.2] = ESCAPE
        ids[rng.random((nblk, bs)) < 0.05] = 200
    ids = np.minimum(ids, ESCAPE).astype(np.uint8)
    ids[:, 0] = ESCAPE
    return ids


def _tight(rows, counts):
    return entropy.take_row_prefixes(np.asarray(rows), np.asarray(counts))


@pytest.mark.parametrize("tail", [0, 37])
@pytest.mark.parametrize("heavy", [False, True])
@pytest.mark.parametrize("nblk", [2, 4, 8, 600])
def test_pack_ids_with_ac_matches_numpy(nblk, heavy, tail):
    """pack_ids_with_ac's id streams are byte-identical to pack_ids_np, and
    its AC rows hold exactly the escaped values in row-major order."""
    rng = np.random.default_rng(nblk * 2 + heavy)
    ids = _ids_grid(rng, nblk, heavy)
    vals = rng.standard_normal(ids.shape).astype(np.float32) * 50
    n = nblk * 64 - tail
    cw = qz.chunk_width(nblk * 64, 64)
    out = idpack.pack_ids_with_ac(jnp.asarray(ids), jnp.asarray(vals), n, B, cw)
    width, packed, exc_rows, exc_counts, ac_rows, ac_counts, dc, ovf = out
    w_np, packed_np, exc_np, counts_np = idpack.pack_ids_np(ids, n, B)
    np.testing.assert_array_equal(np.asarray(width), w_np)
    bpr = idpack.packed_nbytes(np.asarray(width).reshape(-1), B)
    assert _tight(packed, bpr).tobytes() == packed_np
    assert _tight(exc_rows, exc_counts).tobytes() == exc_np
    np.testing.assert_array_equal(np.asarray(exc_counts), counts_np)
    assert not bool(ovf)

    pos = np.arange(nblk * 64).reshape(nblk, 64)
    esc = (ids == ESCAPE) & (pos % 64 >= 1) & (pos < n)
    np.testing.assert_array_equal(
        _tight(ac_rows, ac_counts), vals[esc].astype(np.float32)
    )
    np.testing.assert_array_equal(
        np.asarray(ac_counts), esc.reshape(-1, cw).sum(axis=1)
    )
    np.testing.assert_array_equal(np.asarray(dc), vals[:, 0])


@pytest.mark.parametrize("heavy", [False, True])
@pytest.mark.parametrize("nblk", [2, 8, 600])
def test_pack_unpack_roundtrip(nblk, heavy):
    """unpack_ids inverts pack_ids: real positions come back, DC reads
    ESCAPE, positions past n_valid read 0."""
    rng = np.random.default_rng(100 + nblk + heavy)
    ids = _ids_grid(rng, nblk, heavy)
    n = nblk * 64 - 5
    cw = qz.chunk_width(nblk * 64, 64)
    width, packed, exc_rows, _counts, ovf = idpack.pack_ids(
        jnp.asarray(ids), n, B, cw
    )
    assert not bool(ovf)
    got = np.asarray(idpack.unpack_ids(width, packed, exc_rows, nblk, 64, B, cw))
    want = ids.copy()
    want.reshape(-1)[n:] = 0
    want[:, 0] = ESCAPE
    np.testing.assert_array_equal(got, want)


def _scipy_coeffs(xs, bs):
    """Blockwise orthonormal DCT-II in float64; a partial tail block uses
    the rem-point basis (the reference's re-planned remainder)."""
    n = xs.size
    nfull = n // bs
    main = scipy.fft.dct(xs[: nfull * bs].reshape(nfull, bs), norm="ortho", axis=-1)
    rem = n - nfull * bs
    if not rem:
        return main
    tail = np.zeros((1, bs))
    tail[0, :rem] = scipy.fft.dct(xs[nfull * bs :], norm="ortho")
    return np.concatenate([main, tail])


def _sf_np(amax, sf_adj):
    return 10.0 ** (np.ceil(np.log10(amax)) - sf_adj)


def _bins_np(c, n, cfg):
    """Closed-form binning (binning.py docstring): zigzag id of the linear
    bin for in-range AC coefficients, ESCAPE elsewhere."""
    w = 2.0 * cfg.error_bound * cfg.brsf
    rmax = cfg.range_max
    half = cfg.nbins // 2
    lin = np.clip(np.floor((c + rmax) / w), 0, cfg.nbins - 1).astype(np.int64)
    zz = np.where(lin <= half, 2 * (half - lin), 2 * (lin - half) - 1)
    nblk, bs = c.shape
    pos = np.arange(nblk * bs).reshape(nblk, bs)
    binned = (np.abs(c) <= rmax) & (pos % bs >= 1) & (pos < n)
    return np.where(binned, zz, ESCAPE), w, rmax


@pytest.mark.parametrize("tail", [0, 29])
@pytest.mark.parametrize("eb", [1e-3, 1e-4])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_encode_bins_match_scipy(dtype, eb, tail):
    """api._encode_device's bin ids against a SciPy DCT + the closed-form
    binning. Ids may differ only at ties: where the float64 reference
    coefficient lies within the device dtype's DCT rounding of a bin edge
    (64 * eps * max|x/sf|). float64 has none; float32 is held to at most
    one per 10^3 elements (1 of 6115 in the float32, 1e-3, tail-29 case,
    none in the others)."""
    rng = np.random.default_rng(int(eb * 1e5) + tail)
    n = 64 * 96 - tail
    x = (np.sin(np.arange(n) * 0.05) * 30 + rng.standard_normal(n)).astype(dtype)
    cfg = CodecConfig(error_bound=eb)
    q, stats = api._encode_device(jnp.asarray(x), n, api._device_cfg(cfg))
    sf = _sf_np(np.abs(x.astype(np.float64)).max(), cfg.sf_adj)
    assert float(stats.sf) == pytest.approx(sf, rel=1e-12)
    xs = x.astype(np.float64) / float(stats.sf)
    c = _scipy_coeffs(xs, 64)
    want, w, rmax = _bins_np(c, n, cfg)
    got = np.asarray(q.bin_ids).astype(np.int64)
    diff = got != want
    eps = np.finfo(dtype).eps * 64 * np.abs(xs).max()
    edge_dist = np.abs((c + rmax) / w - np.round((c + rmax) / w)) * w
    ties = diff & (edge_dist <= eps)
    assert (diff == ties).all(), f"{int(diff.sum())} non-tie mismatches"
    limit = 0 if dtype == np.float64 else n * 1e-3
    assert int(diff.sum()) <= limit, f"{int(diff.sum())} tie mismatches"


def _decode_np(ids, dc, stored, qtable, n, cfg, bs=64):
    """NumPy/SciPy decode: bin centers or stored escapes (QT escapes
    un-renormalized through the table), DC in column 0, SciPy IDCT
    (rem-point tail), unscaled by the caller."""
    nblk = ids.shape[0]
    w = 2.0 * cfg.error_bound * cfg.brsf
    rmax = cfg.range_max
    k = ids.astype(np.int64) // 2
    centers = np.where(ids % 2 == 1, k + 1, -k) * w
    pos = np.arange(nblk * bs).reshape(nblk, bs)
    esc = (ids == ESCAPE) & (pos % bs >= 1) & (pos < n)
    vals = stored.astype(np.float64)
    if cfg.mode == "qt":
        side = np.where(vals > 0, rmax, -rmax)
        vals = (vals - side) / (cfg.error_bound * cfg.qt_factor) * qtable[None, :]
    c = np.where(esc, vals, centers)
    c[:, 0] = dc
    nfull = n // bs
    out = scipy.fft.idct(c[:nfull], norm="ortho", axis=-1).reshape(-1)
    rem = n - nfull * bs
    if rem:
        out = np.concatenate([out, scipy.fft.idct(c[nfull, :rem], norm="ortho")])
    return out


def _byte_planes(a):
    """(4, ...) uint8 little-endian byte planes of a float32 array (the PLC
    sections' layout the decode program reassembles on the device)."""
    u = np.asarray(a, np.float32).view(np.uint32)
    return np.stack([((u >> (8 * k)) & 255).astype(np.uint8) for k in range(4)])


@pytest.mark.parametrize("layout", ["values", "planes"])
@pytest.mark.parametrize("tail", [0, 41])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("mode", ["ec", "qt"])
def test_decode_device_dpk_matches_numpy(mode, dtype, tail, layout):
    """api._decode_device_dpk on the DPK streams of a real quantization
    equals the NumPy/SciPy decode of the same ids and stored values, to the
    dtype's DCT rounding (1e-5 relative to max|x| for float32, 1e-12 for
    float64). The DC values and AC rows arrive as float32 values or as
    their byte planes."""
    rng = np.random.default_rng(len(mode) + tail)
    n = 64 * 512 - tail
    x = np.sin(np.arange(n) * 0.02) * 20 + rng.standard_normal(n)
    x[::333] *= 25.0
    x = x.astype(dtype)
    cfg = api._device_cfg(CodecConfig(mode=mode, error_bound=1e-3))
    sf = jnp.asarray(_sf_np(np.abs(x).max(), cfg.sf_adj), dtype)
    main_c, tail_c = transform.forward(jnp.asarray(x) / sf, 64)
    coeffs = api._pad_coeffs(main_c, tail_c, 64)
    ids, stored, dc, qt = qz.quantize(coeffs, n, cfg)
    nblk = ids.shape[0]
    cw = qz.chunk_width(nblk * 64, 64)
    width, packed, exc_rows, _ec, ac_rows, _acn, _dc, ovf = (
        idpack.pack_ids_with_ac(ids, stored, n, B, cw)
    )
    assert not bool(ovf)
    dc_in, ac_in = dc, ac_rows
    if layout == "planes":
        dc_in, ac_in = _byte_planes(dc), _byte_planes(ac_rows)
    y = api._decode_device_dpk(
        width, packed, exc_rows, jnp.asarray(dc_in), jnp.asarray(ac_in), n,
        cfg, dtype, B, cw, sf, qt,
    )
    want = _decode_np(
        np.asarray(ids), np.asarray(dc, np.float64), np.asarray(stored),
        None if qt is None else np.asarray(qt, np.float64), n, cfg,
    ) * float(sf)
    tol = (1e-5 if dtype == "float32" else 1e-12) * np.abs(x).max()
    np.testing.assert_allclose(np.asarray(y, np.float64), want, atol=tol, rtol=0)
