"""Quantizer invariants (reference pass 1 / pass 2, dctz-comp-lib.c:325-544).

The central property: for every NON-escaped coefficient the dequantized bin
center is within error_bound of the original; escaped coefficients round-trip
through float32 exactly (EC) or through the QT renormalization with its
documented precision loss.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from dctz_tpu.config import CodecConfig
from dctz_tpu.core import quantize as qz
from dctz_tpu.core.constants import ESCAPE


def _coeff_grid(rng, nblk=32, bs=64, scale=0.5):
    c = rng.standard_normal((nblk, bs)) * scale
    # Sprinkle large outliers to exercise the escape path.
    mask = rng.random((nblk, bs)) < 0.05
    c = np.where(mask, c * 1000.0, c)
    return c


def _escapes(q, n):
    """Row-major escaped AC positions of q's bin ids (the stream order)."""
    ids = np.asarray(q.bin_ids)
    pos = np.arange(ids.size).reshape(ids.shape)
    return (ids == ESCAPE) & (pos % ids.shape[1] >= 1) & (pos < n)


def _chunk_rows(q, n):
    """The global AC stream of q re-padded into per-chunk rows, as the
    decompress host stage does (entropy.pad_row_prefixes)."""
    from dctz_tpu.core import entropy

    cw = qz.chunk_width(q.bin_ids.size, q.bin_ids.shape[1])
    counts = _escapes(q, n).reshape(-1, cw).sum(axis=1)
    ac = np.asarray(q.ac_buf[: int(q.ac_count)])
    return jnp.asarray(entropy.pad_row_prefixes(ac, counts, cw, ac.dtype))


def _decode(q, n, cfg):
    return np.asarray(
        qz.decode(q.bin_ids, q.dc, _chunk_rows(q, n), q.qtable, n, cfg,
                  jnp.float64)
    )


@pytest.mark.parametrize("mode", ["ec", "qt"])
def test_roundtrip_bound_in_coefficient_domain(mode):
    rng = np.random.default_rng(0)
    eb = 1e-3
    cfg = CodecConfig(mode=mode, error_bound=eb)
    coeffs = _coeff_grid(rng)
    nblk, bs = coeffs.shape
    n = nblk * bs

    q = qz.encode(jnp.asarray(coeffs), n, cfg)
    rec = _decode(q, n, cfg)

    ids = np.asarray(q.bin_ids)
    ac_mask = np.ones((nblk, bs), bool)
    ac_mask[:, 0] = False
    binned = ac_mask & (ids != ESCAPE)
    escaped = ac_mask & (ids == ESCAPE)

    # Non-escaped AC coefficients: bin-center error <= eb.
    err = np.abs(rec - coeffs)
    assert err[binned].max() <= eb * (1 + 1e-12)

    if mode == "ec":
        # EC escapes: only float32 truncation error (dctz-comp-lib.c:537).
        f32 = coeffs.astype(np.float32).astype(np.float64)
        np.testing.assert_array_equal(rec[escaped], f32[escaped])
    else:
        # QT escapes: reconstruction error is bounded by the documented
        # renormalization precision: storing f32(norm) perturbs norm by
        # <= eps32*|norm|, amplified by qtable[j]/(eb*qt_factor).
        qtable = np.asarray(q.qtable)
        amp = qtable[None, :] / (eb * cfg.qt_factor)
        norm_scale = np.abs(coeffs / np.where(qtable[None, :] == 0, 1, qtable))
        tol = (np.finfo(np.float32).eps * (norm_scale * eb * cfg.qt_factor + cfg.range_max + eb)) * amp * 4
        assert (err[escaped] <= tol[escaped] + 1e-12).all()

    # DC: float32-truncated exact save (dctz-comp-lib.c:351).
    np.testing.assert_array_equal(
        rec[:, 0], coeffs[:, 0].astype(np.float32).astype(np.float64)
    )


def test_dc_slots_marked_escape_but_consume_no_ac():
    """bin_index[i*64] == 255 yet AC_exact holds only real escapes
    (dctz-comp-lib.c:361 vs dctz-decomp-lib.c:392-396)."""
    rng = np.random.default_rng(1)
    cfg = CodecConfig(mode="ec", error_bound=1e-3)
    coeffs = np.clip(rng.standard_normal((8, 64)) * 0.01, -0.2, 0.2)
    q = qz.encode(jnp.asarray(coeffs), 8 * 64, cfg)
    ids = np.asarray(q.bin_ids)
    assert (ids[:, 0] == ESCAPE).all()
    assert int(q.ac_count) == 0  # nothing out of range


def test_ac_compaction_order_is_block_major():
    cfg = CodecConfig(mode="ec", error_bound=1e-3)
    coeffs = np.zeros((3, 64))
    # Escapes at (0, 5), (1, 2), (2, 63) with distinct values.
    coeffs[0, 5] = 10.0
    coeffs[1, 2] = 20.0
    coeffs[2, 63] = 30.0
    q = qz.encode(jnp.asarray(coeffs), 3 * 64, cfg)
    assert int(q.ac_count) == 3
    np.testing.assert_array_equal(
        np.asarray(q.ac_buf[:3]), np.array([10.0, 20.0, 30.0], np.float32)
    )


def test_tail_block_positions_excluded():
    """Padding positions in the final partial block never escape into the
    AC stream and their bin ids are sliced away."""
    cfg = CodecConfig(mode="ec", error_bound=1e-3)
    n = 64 + 10  # one full block + 10-element tail
    coeffs = np.zeros((2, 64))
    coeffs[1, 5] = 99.0  # real tail position -> escapes
    coeffs[1, 50] = 99.0  # padding position -> must be ignored
    q = qz.encode(jnp.asarray(coeffs), n, cfg)
    assert int(q.ac_count) == 1
    assert float(q.ac_buf[0]) == 99.0


def test_qtable_structure():
    """qtable: per-position max |escaped coef|, clamped >= 1 for j >= 1,
    slot 0 = DC of the last block (dctz-comp-lib.c:355-360,450-461)."""
    cfg = CodecConfig(mode="qt", error_bound=1e-3)
    coeffs = np.zeros((4, 64))
    coeffs[:, 0] = [1.0, 2.0, 3.0, 4.5]  # DCs
    coeffs[0, 7] = -500.0
    coeffs[2, 7] = 700.0
    coeffs[1, 9] = 0.3  # in range, never escapes
    q = qz.encode(jnp.asarray(coeffs), 4 * 64, cfg)
    qtable = np.asarray(q.qtable)
    assert qtable[0] == 4.5
    assert qtable[7] == 700.0
    assert (qtable[1:][qtable[1:] < 1.0].size) == 0  # clamped
    assert qtable[9] == 1.0


def test_qt_all_outliers_stay_escaped():
    """After renormalization outliers remain outside the bin range, so QT
    stores them all in AC_exact (the re-bin branch is structurally dead in
    the reference too — normalized |value| > range_max always)."""
    rng = np.random.default_rng(2)
    cfg = CodecConfig(mode="qt", error_bound=1e-3)
    coeffs = _coeff_grid(rng, nblk=16)
    n = coeffs.size
    q_ec = qz.encode(jnp.asarray(coeffs), n, CodecConfig(mode="ec", error_bound=1e-3))
    q_qt = qz.encode(jnp.asarray(coeffs), n, cfg)
    assert int(q_qt.ac_count) == int(q_ec.ac_count)


@pytest.mark.parametrize("mode", ["ec", "qt"])
def test_chunked_compaction_matches_global(mode):
    """The chunk-local compaction (ops/compaction.py, the DPK containers'
    AC rows) must produce the exact same AC stream as the global
    cumsum+scatter compaction of qz.encode."""
    from dctz_tpu.ops import compaction as cp

    rng = np.random.default_rng(5)
    cfg = CodecConfig(mode=mode, error_bound=1e-3)
    coeffs = _coeff_grid(rng, nblk=64)
    n = coeffs.size
    qg = qz.encode(jnp.asarray(coeffs), n, cfg)
    ids, stored, _dc, _qt = qz.quantize(jnp.asarray(coeffs), n, cfg)
    np.testing.assert_array_equal(np.asarray(qg.bin_ids), np.asarray(ids))
    esc = np.asarray(ids) == ESCAPE
    esc[:, 0] = False
    cw = qz.chunk_width(n, 64)
    rows, counts, ovf = cp.compact_chunked(
        jnp.asarray(esc.reshape(-1)), stored.reshape(-1), cw, cw
    )
    counts = np.asarray(counts)
    sel = np.arange(cw)[None, :] < counts[:, None]
    np.testing.assert_array_equal(
        np.asarray(qg.ac_buf[: int(qg.ac_count)]), np.asarray(rows)[sel]
    )
    assert int(qg.ac_count) == int(counts.sum())
    assert not bool(ovf)


@pytest.mark.parametrize("mode", ["ec", "qt"])
def test_chunked_decode_matches_global(mode):
    """Decoding from per-chunk rows places every entry of the global AC
    stream exactly where the k-th-escape-reads-k-th-entry rule puts it
    (the placement done here in NumPy, decoded through the dense layout)."""
    rng = np.random.default_rng(6)
    cfg = CodecConfig(mode=mode, error_bound=1e-3)
    coeffs = _coeff_grid(rng, nblk=64)
    n = coeffs.size
    q = qz.encode(jnp.asarray(coeffs), n, cfg)
    ac = np.asarray(q.ac_buf[: int(q.ac_count)])
    dense = np.zeros(coeffs.shape, np.float32)
    dense[_escapes(q, n)] = ac
    rec_g = np.asarray(
        qz.decode(
            q.bin_ids, q.dc, jnp.asarray(dense), q.qtable, n, cfg,
            jnp.float64, ac_layout="dense",
        )
    )
    np.testing.assert_array_equal(rec_g, _decode(q, n, cfg))


def test_chunked_overflow_flag():
    from dctz_tpu.ops import compaction as cp

    cfg = CodecConfig(mode="ec", error_bound=1e-3)
    coeffs = np.full((64, 64), 1e6)  # every AC escapes
    ids, stored, _dc, _qt = qz.quantize(jnp.asarray(coeffs), 64 * 64, cfg)
    esc = (np.asarray(ids) == ESCAPE) & (np.arange(64)[None, :] >= 1)
    cw = qz.chunk_width(64 * 64, 64)
    _r, _c, ovf = cp.compact_chunked(
        jnp.asarray(esc.reshape(-1)), stored.reshape(-1), cw, 16
    )
    assert bool(ovf)
    _r, counts, ovf2 = cp.compact_chunked(
        jnp.asarray(esc.reshape(-1)), stored.reshape(-1), cw, cw
    )
    assert not bool(ovf2)
    assert int(np.asarray(counts).sum()) == 64 * 63


def test_escape_id_boundary_clamp():
    """A coefficient exactly at +range_max is in-range; the reference would
    index conv_tbl[255] (UB) — we clamp to the outermost bin, whose center
    is exactly one bin width away (documented deviation)."""
    cfg = CodecConfig(mode="ec", error_bound=1e-3)
    coeffs = np.zeros((1, 64))
    coeffs[0, 1] = cfg.range_max
    q = qz.encode(jnp.asarray(coeffs), 64, cfg)
    ids = np.asarray(q.bin_ids)
    assert ids[0, 1] != ESCAPE
    rec = _decode(q, 64, cfg)
    assert abs(rec[0, 1] - cfg.range_max) <= 2 * cfg.error_bound
