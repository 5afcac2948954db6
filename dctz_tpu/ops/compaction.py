"""Chunk-local variable-length stream compaction.

Fixed-shape compaction of masked values in chunks of `cw` elements, used
wherever the DPK format stores per-chunk rows: the exception stream of the
device id coder (ops/idpack.py) and the AC rows of DPK containers.

  encode: per chunk, move masked values to the front in order via one
    batched `lax.sort` along the minor axis and keep only `capc` slots. The
    host concatenates the per-chunk prefixes, which gives exactly the global
    row-major stream because chunks are contiguous. Chunks that overflow
    `capc` raise a flag; the caller re-runs the capc == cw variant (always
    lossless).

  decode: placement of the compacted stream back to masked positions is a
    per-chunk permutation, expressed as a one-hot contraction. Each output
    element receives exactly one term, so float arithmetic is exact.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

CHUNK_W = 512  # elements per compaction chunk (8 DCT blocks)
CAPC = 128  # default escape capacity per chunk (fallback: CHUNK_W)

_INTMAX = jnp.iinfo(jnp.int32).max


def compact_chunked(
    flat_mask: jax.Array,
    flat_vals: jax.Array,
    cw: int = CHUNK_W,
    capc: int = CAPC,
):
    """Compact masked values chunk-locally.

    flat_mask/flat_vals: (n,) with n % cw == 0 (encoder pads to blocks which
    divide cw). Returns (ac_chunks (n/cw, capc), counts (n/cw,) int32,
    overflowed () bool). Values beyond each chunk's count are zeros.
    """
    n = flat_mask.shape[0]
    assert n % cw == 0, (n, cw)
    nc = n // cw
    mask2 = flat_mask.reshape(nc, cw)
    vals2 = flat_vals.reshape(nc, cw)
    counts = jnp.sum(mask2, axis=-1, dtype=jnp.int32)
    overflowed = jnp.any(counts > capc)
    keys = jnp.where(
        mask2, jax.lax.broadcasted_iota(jnp.int32, (nc, cw), 1), _INTMAX
    )
    skeys, svals = jax.lax.sort((keys, vals2), dimension=-1, num_keys=1)
    ac = jnp.where(
        skeys[:, :capc] != _INTMAX, svals[:, :capc], jnp.zeros_like(svals[:, :capc])
    )
    return ac, counts, overflowed


def expand_chunked(
    mask2: jax.Array,
    ac_chunks: jax.Array,
) -> jax.Array:
    """Inverse of compact_chunked: values back at masked positions (else 0).

    mask2: (nc, cw) bool; ac_chunks: (nc, capc). The k-th masked position of
    chunk c receives ac_chunks[c, k], computed as a one-hot contraction
    (each output gets exactly one term, so the float arithmetic is exact).

    Callers whose values fit bf16 exactly (e.g. id BYTES <= 255: 8
    significant bits) should pass ac_chunks as bfloat16 — the one-hot
    operand and the picked-value intermediate halve in HBM traffic and the
    f32-accumulated result is still exact; output dtype follows the input.
    """
    nc, cw = mask2.shape
    capc = ac_chunks.shape[1]
    rank = jnp.cumsum(mask2.astype(jnp.int32), axis=-1) - 1  # (nc, cw)
    rank = jnp.where(mask2, rank, -1)
    lo_w = 16
    if capc % lo_w or capc <= lo_w:
        # single full-width one-hot (small caps / odd geometry)
        onehot = (
            rank[:, :, None]
            == jnp.arange(capc, dtype=jnp.int32)[None, None, :]
        ).astype(ac_chunks.dtype)
        return jnp.einsum(
            "cjk,ck->cj",
            onehot,
            ac_chunks,
            precision=jax.lax.Precision.HIGHEST,
        )
    # rank = hi*lo_w + lo decomposition: the materialized one-hot shrinks
    # from capc to lo_w columns (the HBM cost center — the full (nc, cw,
    # capc) f32 operand is ~17 GB of traffic at bench shapes). Step 1 picks
    # vals[c, h, lo(j)] for EVERY hi-group h via a small batched matmul;
    # step 2 selects the right group with a fused iota-compare + reduce.
    # Each output still receives exactly one term -> f32 arithmetic exact.
    hi_n = capc // lo_w
    vals3 = ac_chunks.reshape(nc, hi_n, lo_w)
    ohl = (
        (rank & (lo_w - 1))[:, :, None]
        == jnp.arange(lo_w, dtype=jnp.int32)[None, None, :]
    ).astype(ac_chunks.dtype)  # (nc, cw, lo_w)
    t = jax.lax.dot_general(
        ohl,
        vals3,
        (((2,), (2,)), ((0,), (0,))),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )  # (nc, cw, hi_n) f32 accumulation (exact even for bf16 operands)
    ohh = jnp.where(
        mask2[:, :, None]
        & (
            (rank >> (lo_w.bit_length() - 1))[:, :, None]
            == jnp.arange(hi_n, dtype=jnp.int32)[None, None, :]
        ),
        jnp.float32(1),
        jnp.float32(0),
    )
    return jnp.sum(t * ohh, axis=2).astype(ac_chunks.dtype)

