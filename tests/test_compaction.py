"""Chunk-local compaction (ops/compaction.py) against NumPy references.

compact_chunked / expand_chunked carry the DPK containers' exception stream
and AC rows on every backend; the NumPy loops below are the plain
semantics: per chunk of `cw` elements, the masked values in order, zero
padded to `capc` slots."""

import jax.numpy as jnp
import numpy as np
import pytest

from dctz_tpu.ops import compaction as cp

CWS = [128, 256, 512, 1024, 2048]


def _mask_vals(rng, nc, cw, density, dtype):
    mask = rng.random((nc, cw)) < density
    vals = (rng.standard_normal((nc, cw)) * 100).astype(dtype)
    return mask, vals


def _compact_np(mask, vals, capc):
    nc, _ = mask.shape
    out = np.zeros((nc, capc), vals.dtype)
    for c in range(nc):
        picked = vals[c][mask[c]][:capc]
        out[c, : picked.size] = picked
    return out, mask.sum(axis=1)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("density", [0.01, 0.3, 0.95])
@pytest.mark.parametrize("cw", CWS)
def test_compact_chunked_matches_numpy(cw, density, dtype):
    rng = np.random.default_rng(cw + int(density * 100))
    nc = 8
    mask, vals = _mask_vals(rng, nc, cw, density, dtype)
    rows, counts, ovf = cp.compact_chunked(
        jnp.asarray(mask.reshape(-1)), jnp.asarray(vals.reshape(-1)), cw, cw
    )
    want, want_counts = _compact_np(mask, vals, cw)
    np.testing.assert_array_equal(np.asarray(rows), want)
    np.testing.assert_array_equal(np.asarray(counts), want_counts)
    assert not bool(ovf)
    # a capacity below the densest chunk raises the overflow flag and keeps
    # the first `capc` values of every chunk
    capc = 16
    rows2, _c, ovf2 = cp.compact_chunked(
        jnp.asarray(mask.reshape(-1)), jnp.asarray(vals.reshape(-1)), cw, capc
    )
    assert bool(ovf2) == bool(want_counts.max() > capc)
    np.testing.assert_array_equal(np.asarray(rows2), want[:, :capc])


@pytest.mark.parametrize("capc", [16, 48, 128])
@pytest.mark.parametrize("cw", [128, 512, 2048])
def test_expand_chunked_inverts_compaction(cw, capc):
    """Both contraction arms (single one-hot for capc <= 16, the hi/lo
    split otherwise) place the k-th value at the k-th masked position,
    exactly."""
    rng = np.random.default_rng(cw * capc)
    nc = 6
    mask = np.zeros((nc, cw), bool)
    for c in range(nc):  # up to capc masked positions per chunk
        k = int(rng.integers(0, capc + 1))
        mask[c, rng.choice(cw, k, replace=False)] = True
    rows, _counts = _compact_np(
        mask, (rng.standard_normal((nc, cw)) * 1e3).astype(np.float32), capc
    )
    got = np.asarray(cp.expand_chunked(jnp.asarray(mask), jnp.asarray(rows)))
    want = np.zeros((nc, cw), np.float32)
    for c in range(nc):
        want[c, mask[c]] = rows[c, : mask[c].sum()]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cw", [128, 512, 2048])
def test_expand_chunked_bytes_in_bfloat16(cw):
    """Id bytes (<= 255, 8 significant bits) expand exactly through a
    bfloat16 operand, the form idpack.unpack_ids uses."""
    rng = np.random.default_rng(cw)
    nc, capc = 4, 128
    mask = rng.random((nc, cw)) < (capc / cw) * 0.9
    for c in range(nc):
        idx = np.flatnonzero(mask[c])[capc:]
        mask[c, idx] = False
    byts = rng.integers(0, 256, (nc, cw)).astype(np.float32)
    rows, _ = _compact_np(mask, byts, capc)
    got = cp.expand_chunked(jnp.asarray(mask), jnp.asarray(rows, jnp.bfloat16))
    want = np.zeros((nc, cw), np.float32)
    for c in range(nc):
        want[c, mask[c]] = rows[c, : mask[c].sum()]
    np.testing.assert_array_equal(np.asarray(got, np.float32), want)
