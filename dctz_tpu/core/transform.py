"""Orthonormal block DCT-II/III as batched matmuls.

The reference computes a per-block DCT through complex FFTs (Makhoul's
even/odd reordering, reference: dct.c:24-103 double, dct-float.c float) with
FFTW plans cached in file-static state, re-planned for the remainder block
(dctz-comp-lib.c:326-336). That construction is numerically identical to the
orthonormal DCT-II (verified to ~1e-16 against scipy.fft.dct(norm='ortho')).

At block size 64 an FFT buys nothing: the transform is a fixed 64x64
orthonormal matrix, so the whole array transforms as ONE batched matmul,
(nblk, 64) @ B.T, and the inverse is the transpose. Both run at
Precision.HIGHEST (true float32; a GPU would otherwise use TF32, whose
rounding breaks the error bound). The remainder
block (N % 64 != 0) uses a rem-point basis, matching the reference's
re-planned rem-point FFT (dct.c:55-103 with dn=rem), not a padded 64-point
transform; rem is static under jit because shapes are static.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.lru_cache(maxsize=32)
def _dct2_basis_np(n: int) -> np.ndarray:
    """Orthonormal DCT-II basis B with shape (n, n), float64.

    B[k, m] = w(k) * cos(pi * (2m + 1) * k / (2n)),
    w(0) = sqrt(1/n), w(k>0) = sqrt(2/n).

    Rows are the analysis vectors: coeffs = B @ x; x = B.T @ coeffs.
    """
    k = np.arange(n)[:, None].astype(np.float64)
    m = np.arange(n)[None, :].astype(np.float64)
    basis = np.cos(np.pi * (2.0 * m + 1.0) * k / (2.0 * n))
    basis *= np.sqrt(2.0 / n)
    basis[0] /= np.sqrt(2.0)
    return basis


def dct2_basis(n: int, dtype=jnp.float32) -> jax.Array:
    """The (n, n) orthonormal DCT-II basis as a device constant."""
    return jnp.asarray(_dct2_basis_np(n), dtype=dtype)


def block_dct_flat(
    x: jax.Array, block_size: int, precision=jax.lax.Precision.HIGHEST
) -> jax.Array:
    """Forward DCT of a flat array whose length is a block multiple;
    returns (nblk, block_size)."""
    return block_dct(x.reshape(-1, block_size), precision=precision)


def block_idct_flat(coeffs: jax.Array) -> jax.Array:
    """Inverse of block_dct_flat: (nblk, bs) -> flat (nblk*bs,)."""
    return block_idct(coeffs).reshape(-1)


def block_dct(
    blocks: jax.Array,
    basis: jax.Array | None = None,
    precision=jax.lax.Precision.HIGHEST,
) -> jax.Array:
    """Forward DCT-II of a batch of blocks: (..., n) -> (..., n).

    Equivalent to the reference's per-block dct_fftw loop
    (dctz-comp-lib.c:325-340) collapsed into one matmul.
    """
    n = blocks.shape[-1]
    if basis is None:
        basis = dct2_basis(n, blocks.dtype)
    return jnp.matmul(blocks, basis.T, precision=precision)


def block_idct(coeffs: jax.Array, basis: jax.Array | None = None) -> jax.Array:
    """Inverse DCT (DCT-III) of a batch of blocks: (..., n) -> (..., n).

    Equivalent to the reference's per-block ifft_idct loop
    (dctz-decomp-lib.c:389-483 -> dct.c:115-205).
    """
    n = coeffs.shape[-1]
    if basis is None:
        basis = dct2_basis(n, coeffs.dtype)
    return jnp.matmul(coeffs, basis, precision=jax.lax.Precision.HIGHEST)


def split_blocks(x: jax.Array, block_size: int) -> tuple[jax.Array, jax.Array]:
    """Split a flat array into (full_blocks, tail).

    full_blocks: (N // block_size, block_size); tail: (N % block_size,).
    Shapes are static, so the tail branch traces away when N % block_size == 0.
    """
    n_full = x.shape[0] // block_size
    main = x[: n_full * block_size].reshape(n_full, block_size)
    tail = x[n_full * block_size :]
    return main, tail


def forward(
    x: jax.Array, block_size: int, precision=jax.lax.Precision.HIGHEST
) -> tuple[jax.Array, jax.Array]:
    """Blockwise forward DCT of a flat array.

    Returns (main_coeffs (n_full, block_size), tail_coeffs (rem,)).
    The tail uses a rem-point orthonormal DCT like the reference's re-planned
    remainder block (dctz-comp-lib.c:326-336).
    """
    main, tail = split_blocks(x, block_size)
    main_c = block_dct_flat(main.reshape(-1), block_size, precision=precision)
    if tail.shape[0] > 0:
        tail_c = block_dct(tail[None, :], precision=precision)[0]
    else:
        tail_c = tail
    return main_c, tail_c


def inverse(main_c: jax.Array, tail_c: jax.Array) -> jax.Array:
    """Blockwise inverse DCT; concatenates back to a flat array."""
    main = block_idct_flat(main_c)
    if tail_c.shape[0] > 0:
        tail = block_idct(tail_c[None, :])[0]
        return jnp.concatenate([main, tail])
    return main
