"""Device-side entropy coding of the bin-index stream ("DPK").

Replaces the host IDS4-nibble + rANS/deflate stage (the round-1 end-to-end
bottleneck, reference role at dctz-comp-lib.c:620-732) with a device
transform whose output leaves the device ALREADY CODED — the host only
slices and concatenates.

Scheme (per-chunk fixed-width packing, refined per coefficient position):

  The bin-id distribution is strongly position-dependent inside a DCT block:
  low-frequency positions carry large ids, high-frequency positions are
  almost all zero. Flat fixed-width chunking therefore fails (every chunk
  contains a wide id), but TRANSPOSED tiles are near-homogeneous:

  1. nibble = min(id, 15); DC positions (col 0, always the ESCAPE mark) and
     padding are forced to 0 — both are reconstructed, not stored.
  2. tile the (position j) x (B consecutive blocks) grid; per tile choose a
     bit width w in {0,1,2,3,4} minimizing
     w*B + EXC_BITS * count(nibble >= 2^w - 1): values below the marker
     thr = 2^w - 1 pack verbatim at w bits; values >= thr pack as the marker
     and append their ORIGINAL id byte to the exception stream
     (patched-frame-of-reference, generalizing the v2 IDS4 filter whose
     fixed w=4 / thr=15 is the special case).
  3. w=0 tiles (all-zero: smooth data at high frequencies) emit nothing.
  4. exceptions ride the SAME block-major chunk-compaction machinery as the
     AC stream (ops/compaction.py, chunk width = quantize.chunk_width):
     per-tile exception lists are pathologically skewed (a low-frequency
     position row can be ALL exceptions), while block-major chunks spread
     them evenly — smaller capacities and no second device transpose. The tight exception stream is
     simply the exception bytes in global element order.

  Everything is static-shaped elementwise work: width selection is a handful of
  tile reductions; packing is reshape + shift + or at each candidate width
  with a per-tile select; the only data movement is ONE uint8 transpose of
  the nibble grid each way. No scatter/gather anywhere.

  Measured on the bench workload (32Mi climate f32, EC 1E-3): ~1.9 bits per
  nibble INCLUDING deflated exceptions — better than the host rANS path's
  ~2.4 (per-position packing exposes the structure; the host deflate of the
  small exception stream is extremely effective), at ~0 host cost for the
  dominant packed section.

Container: the packed bytes, per-tile widths, exception stream and counts
ride a v2 container with the DPK flag (core/container.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core import constants as C
from . import compaction as cp

B_DEFAULT = 256  # blocks per tile (128-byte max packed row)
CAPE = 128  # default per-chunk exception capacity (fallback: chunk width)
EXC_BITS = 8  # width-selection penalty per exception byte (pre-deflate)
_WIDTHS = (0, 1, 2, 3, 4)
_INF = jnp.int32(1 << 30)
_INTMAX = jnp.iinfo(jnp.int32).max


def tiles_of(nblk: int, b: int) -> int:
    return -(-nblk // b)


# ---------------------------------------------------------------------------
# fixed-width bit packing of 4-bit values (vectorized, no data movement)
# ---------------------------------------------------------------------------


def _pack_w(vals: jax.Array, wb: int, b: int) -> jax.Array:
    """Pack (..., B) int32 nibbles (< 2^wb) into (..., B*wb//8) bytes."""
    if wb in (1, 2, 4):
        g = 8 // wb
        v = vals.reshape(*vals.shape[:-1], b // g, g)
        shifts = jnp.arange(g, dtype=jnp.int32) * wb
        byte = jnp.sum(v << shifts, axis=-1)
        return byte.astype(jnp.uint8)
    assert wb == 3
    v = vals.reshape(*vals.shape[:-1], b // 8, 8)
    shifts = jnp.arange(8, dtype=jnp.int32) * 3
    w24 = jnp.sum(v << shifts, axis=-1)  # 24 bits, little-endian groups
    by = jnp.stack(
        [w24 & 255, (w24 >> 8) & 255, (w24 >> 16) & 255], axis=-1
    )
    return by.reshape(*vals.shape[:-1], 3 * b // 8).astype(jnp.uint8)


def _unpack_w(rows: jax.Array, wb: int, b: int) -> jax.Array:
    """Inverse of _pack_w reading the (..., >=B*wb//8) byte-row prefix."""
    if wb in (1, 2, 4):
        g = 8 // wb
        by = rows[..., : b // g].astype(jnp.int32)
        shifts = jnp.arange(g, dtype=jnp.int32) * wb
        v = (by[..., None] >> shifts) & ((1 << wb) - 1)
        return v.reshape(*rows.shape[:-1], b)
    assert wb == 3
    by = rows[..., : 3 * b // 8].astype(jnp.int32)
    by = by.reshape(*rows.shape[:-1], b // 8, 3)
    w24 = by[..., 0] | (by[..., 1] << 8) | (by[..., 2] << 16)
    shifts = jnp.arange(8, dtype=jnp.int32) * 3
    v = (w24[..., None] >> shifts) & 7
    return v.reshape(*rows.shape[:-1], b)


def packed_nbytes(widths: np.ndarray, b: int) -> np.ndarray:
    """Per-tile packed byte counts for host slicing/assembly."""
    return (widths.astype(np.int64) * b) // 8


def _thr_block_major(width: jax.Array, nblk: int, b: int) -> jax.Array:
    """Per-tile markers broadcast to the (nblk, bs) block-major grid.

    width is TILE-MAJOR (T, bs): global tile index is the leading axis so
    per-shard grids concatenate into the global one (parallel/sharding.py).
    """
    t, bs = width.shape
    w32 = width.astype(jnp.int32)
    thr = jnp.where(w32 > 0, (1 << w32) - 1, _INF)  # (T, bs)
    thr_bm = jnp.broadcast_to(thr[:, None, :], (t, b, bs)).reshape(t * b, bs)
    return thr_bm[:nblk]


# ---------------------------------------------------------------------------
# device encode
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnums=(2, 3))
def pack_ids(ids2d: jax.Array, n_valid, b: int, cape: int):
    """Code the bin-index grid on device.

    ids2d: (nblk, bs) uint8 (DC col = ESCAPE, padding = anything).
    n_valid: true element count, int or traced scalar (positions >= n_valid
    are coded as 0 — traced so the sharded path can pass per-shard counts).

    Returns (widths (T, bs) uint8, packed (T*bs, b//2) uint8,
    exc_rows (nchunks, cape) uint8, exc_counts (nchunks,) int32,
    exc_overflow () bool) where nchunks = nblk*bs / quantize.chunk_width.
    All outputs are TILE-MAJOR / block-major: per-shard outputs concatenate
    along their leading axis into exactly the single-chip global layout.
    """
    from ..core.quantize import chunk_width

    nblk, bs = ids2d.shape
    t = tiles_of(nblk, b)

    row = jax.lax.broadcasted_iota(jnp.int32, (nblk, bs), 0)
    col = jax.lax.broadcasted_iota(jnp.int32, (nblk, bs), 1)
    valid = (row * bs + col < n_valid) & (col >= 1)  # DC + padding -> 0
    ids_i = jnp.where(valid, ids2d.astype(jnp.int32), 0)
    nib_bm = jnp.minimum(ids_i, 15)  # (nblk, bs) int32

    # ONE transpose to (tile, position, block) tiles, on int32 values
    pad = t * b - nblk
    nib_p = jnp.pad(nib_bm, ((0, pad), (0, 0))) if pad else nib_bm
    tiles = jnp.swapaxes(nib_p.reshape(t, b, bs), 1, 2)  # (T, bs, B)

    # width selection: cost(w) = w*B + EXC_BITS * #exceptions(w)
    maxv = jnp.max(tiles, axis=-1)
    costs = [jnp.where(maxv == 0, jnp.int32(0), _INF)]
    for wb in _WIDTHS[1:]:
        thr = (1 << wb) - 1
        cnt = jnp.sum((tiles >= thr).astype(jnp.int32), axis=-1)
        costs.append(jnp.int32(wb * b) + jnp.int32(EXC_BITS) * cnt)
    width = jnp.argmin(jnp.stack(costs), axis=0).astype(jnp.int32)  # (T, bs)

    # pack at every candidate width, select per tile (values clipped to the
    # marker so exceptions pack as thr)
    cap = b // 2
    packed = jnp.zeros((t, bs, cap), jnp.uint8)
    for wb in _WIDTHS[1:]:
        thr = (1 << wb) - 1
        pk = _pack_w(jnp.minimum(tiles, thr), wb, b)
        pk = jnp.pad(pk, ((0, 0), (0, 0), (0, cap - pk.shape[-1])))
        packed = jnp.where((width == wb)[..., None], pk, packed)

    # exceptions: original id bytes wherever nibble >= marker, compacted in
    # BLOCK-MAJOR chunks (global element order — same machinery as the AC
    # stream, evenly loaded)
    thr_bm = _thr_block_major(width, nblk, b)
    exc_mask = nib_bm >= thr_bm
    cw = chunk_width(nblk * bs, bs)
    exc_rows, exc_counts, exc_ovf = cp.compact_chunked(
        exc_mask.reshape(-1), ids_i.reshape(-1), cw, min(cape, cw)
    )
    return (
        width.astype(jnp.uint8),
        packed.reshape(t * bs, cap),
        exc_rows.astype(jnp.uint8),
        exc_counts,
        exc_ovf,
    )


@functools.partial(jax.jit, static_argnums=(3, 4))
def pack_ids_with_ac(
    ids2d: jax.Array, dcac2d: jax.Array, n_valid, b: int, cape: int
):
    """pack_ids + AC compaction sharing ONE chunk sort (the DPK segment
    encode of stream.py).

    Every AC escape (id == ESCAPE -> nibble 15) is also a DPK exception
    (its tile's width w satisfies 1 <= w <= 4, so 15 >= 2^w - 1), so one
    sort over the exception mask compacts BOTH streams: the id byte rides
    the low 8 bits of the position key (position order is untouched —
    positions are distinct, the byte only pads the key), the escaped
    coefficient rides as the sort payload. AC values are then tightened out
    of the cape-wide union rows by a second sort that is cw/cape times
    narrower than the one it replaces.

    ids2d/dcac2d: the quantizer's (nblk, bs) bin ids and in-place stored
    values (quantize.quantize / repair.verify_repair; column 0 holds the
    DC coefficient). Returns
    (width (T,bs) u8, packed (T*bs, b//2) u8, exc_rows (nc,cape) u8,
    exc_counts (nc,) i32, ac_rows (nc,cape) f32, ac_counts (nc,) i32,
    dc (nblk,) f32, overflow () bool) — byte-identical streams to
    pack_ids + compaction.compact_chunked (tests/test_idpack.py).
    """
    from ..core.quantize import chunk_width

    nblk, bs = ids2d.shape
    t = tiles_of(nblk, b)

    row = jax.lax.broadcasted_iota(jnp.int32, (nblk, bs), 0)
    col = jax.lax.broadcasted_iota(jnp.int32, (nblk, bs), 1)
    valid = (row * bs + col < n_valid) & (col >= 1)
    ids_i = jnp.where(valid, ids2d.astype(jnp.int32), 0)
    nib_bm = jnp.minimum(ids_i, 15)

    pad = t * b - nblk
    nib_p = jnp.pad(nib_bm, ((0, pad), (0, 0))) if pad else nib_bm
    tiles = jnp.swapaxes(nib_p.reshape(t, b, bs), 1, 2)  # (T, bs, B)

    maxv = jnp.max(tiles, axis=-1)
    costs = [jnp.where(maxv == 0, jnp.int32(0), _INF)]
    for wb in _WIDTHS[1:]:
        thr = (1 << wb) - 1
        cnt = jnp.sum((tiles >= thr).astype(jnp.int32), axis=-1)
        costs.append(jnp.int32(wb * b) + jnp.int32(EXC_BITS) * cnt)
    width = jnp.argmin(jnp.stack(costs), axis=0).astype(jnp.int32)

    cap = b // 2
    packed = jnp.zeros((t, bs, cap), jnp.uint8)
    for wb in _WIDTHS[1:]:
        thr = (1 << wb) - 1
        pk = _pack_w(jnp.minimum(tiles, thr), wb, b)
        pk = jnp.pad(pk, ((0, 0), (0, 0), (0, cap - pk.shape[-1])))
        packed = jnp.where((width == wb)[..., None], pk, packed)

    # ---- unified compaction ----
    thr_bm = _thr_block_major(width, nblk, b)
    exc_mask = nib_bm >= thr_bm
    cw = chunk_width(nblk * bs, bs)
    cape = min(cape, cw)
    nc = (nblk * bs) // cw
    mask2 = exc_mask.reshape(nc, cw)
    ids2 = ids_i.reshape(nc, cw)
    vals2 = dcac2d.reshape(nc, cw)
    exc_counts = jnp.sum(mask2, axis=-1, dtype=jnp.int32)
    pos = jax.lax.broadcasted_iota(jnp.int32, (nc, cw), 1)
    keys = jnp.where(mask2, (pos << 8) | ids2, _INTMAX)
    skeys, svals = jax.lax.sort((keys, vals2), dimension=-1, num_keys=1)
    v = skeys[:, :cape] != _INTMAX
    exc_rows = jnp.where(v, skeys[:, :cape] & 255, 0).astype(jnp.uint8)
    union_vals = jnp.where(v, svals[:, :cape], 0.0)

    # stage 2: tighten the AC escapes (id byte == ESCAPE) from the union
    esc2 = v & (exc_rows == jnp.uint8(C.ESCAPE))
    pos2 = jax.lax.broadcasted_iota(jnp.int32, (nc, cape), 1)
    keys2 = jnp.where(esc2, pos2, _INTMAX)
    sk2, ac_rows = jax.lax.sort(
        (keys2, union_vals), dimension=-1, num_keys=1
    )
    ac_rows = jnp.where(sk2 != _INTMAX, ac_rows, 0.0)
    # true per-chunk escape totals (not clipped by cape): drives the retry
    # flag and header.ac_count exactly like compact_chunked's counts
    esc_full = mask2 & (ids2 == C.ESCAPE)
    ac_counts = jnp.sum(esc_full, axis=-1, dtype=jnp.int32)

    overflow = jnp.any(exc_counts > cape)
    dc = dcac2d[:, 0]
    return (
        width.astype(jnp.uint8),
        packed.reshape(t * bs, cap),
        exc_rows,
        exc_counts,
        ac_rows,
        ac_counts,
        dc,
        overflow,
    )


@functools.partial(jax.jit, static_argnums=(1, 2))
def ac_chunk_counts(ids2d: jax.Array, n_valid: int, cw: int) -> jax.Array:
    """Per-chunk AC escape counts (stored in DPK containers so decompress
    never rescans the id stream — replaces api._chunk_escape_counts)."""
    nblk, bs = ids2d.shape
    row = jax.lax.broadcasted_iota(jnp.int32, (nblk, bs), 0)
    col = jax.lax.broadcasted_iota(jnp.int32, (nblk, bs), 1)
    esc = (
        (ids2d.astype(jnp.int32) == C.ESCAPE)
        & (col >= 1)
        & (row * bs + col < n_valid)
    )
    return jnp.sum(
        esc.reshape(-1, cw).astype(jnp.int32), axis=-1, dtype=jnp.int32
    )


# ---------------------------------------------------------------------------
# device decode
# ---------------------------------------------------------------------------


def unpack_ids(
    width: jax.Array,
    packed: jax.Array,
    exc_rows: jax.Array,
    nblk: int,
    bs: int,
    b: int,
    cw: int | None = None,
) -> jax.Array:
    """Inverse of pack_ids -> (nblk, bs) uint8 with DC marks restored.

    width: (T, bs) uint8/int32; packed: (T*bs, b//2) uint8 capacity rows;
    exc_rows: (nchunks, cape) uint8 in block-major chunk order. Positions
    beyond the original n decode to id 0 (the caller slices by true length).
    """
    from ..core.quantize import chunk_width

    t = width.shape[0]
    wcol = width.reshape(t * bs).astype(jnp.int32)

    nib = jnp.zeros((t * bs, b), jnp.int32)
    for wb in _WIDTHS[1:]:
        v = _unpack_w(packed, wb, b)
        nib = jnp.where((wcol == wb)[:, None], v, nib)

    # fold the exception-marker mask into the nibble word BEFORE the
    # transpose (bit 8), so one int32 transpose moves both and no
    # block-major threshold grid is materialized
    thr_col = jnp.where(wcol > 0, (1 << wcol) - 1, jnp.int32(-1))
    comb = nib | ((nib == thr_col[:, None]).astype(jnp.int32) << 8)
    comb_bm = jnp.swapaxes(comb.reshape(t, bs, b), 1, 2).reshape(t * b, bs)[
        :nblk
    ]
    mask = comb_bm >= 256
    nib_bm = comb_bm & 255
    # cw must match the ENCODER's chunk geometry (stored in the container
    # meta; sharded encoders chunk per shard)
    cw = cw or chunk_width(nblk * bs, bs)
    # exception bytes return via the same one-hot contraction as the AC
    # stream; values <= 255 have 8 significant bits -> exact in bfloat16,
    # which halves the expansion's HBM traffic (see expand_chunked)
    exc = cp.expand_chunked(
        mask.reshape(-1, cw), exc_rows.astype(jnp.bfloat16)
    ).reshape(nblk, bs)
    ids = jnp.where(mask, exc.astype(jnp.int32), nib_bm)
    col = jax.lax.broadcasted_iota(jnp.int32, (nblk, bs), 1)
    ids = jnp.where(col == 0, jnp.int32(C.ESCAPE), ids)
    return ids.astype(jnp.uint8)


# ---------------------------------------------------------------------------
# numpy oracle (tests + host fallback)
# ---------------------------------------------------------------------------


def pack_ids_np(ids2d: np.ndarray, n_valid: int, b: int):
    """Pure-numpy reference of pack_ids (unbounded exception capacity).

    Returns (widths (T,bs) u8, tight_packed bytes, exceptions bytes,
    exc_counts per block-major chunk) — tight (host-assembled) layout."""
    from ..core.quantize import chunk_width

    nblk, bs = ids2d.shape
    t = tiles_of(nblk, b)
    pos = np.arange(nblk * bs).reshape(nblk, bs)
    col = np.arange(bs)[None, :]
    valid = (pos < n_valid) & (col >= 1)
    ids_i = np.where(valid, ids2d.astype(np.int64), 0)
    nib_bm = np.minimum(ids_i, 15)
    padw = t * b - nblk
    nib_p = np.pad(nib_bm, ((0, padw), (0, 0))) if padw else nib_bm
    tiles = nib_p.reshape(t, b, bs).swapaxes(1, 2)  # (T, bs, B)

    maxv = tiles.max(axis=-1)
    costs = [np.where(maxv == 0, 0, 1 << 30)]
    for wb in _WIDTHS[1:]:
        thr = (1 << wb) - 1
        costs.append(wb * b + EXC_BITS * (tiles >= thr).sum(axis=-1))
    width = np.argmin(np.stack(costs), axis=0)  # (T, bs)

    out = []
    for ti in range(t):
        for j in range(bs):
            wb = int(width[ti, j])
            tile = tiles[ti, j]
            if wb == 0:
                continue
            thr = (1 << wb) - 1
            clipped = np.minimum(tile, thr)
            if wb != 3:
                g = 8 // wb
                shifts = (np.arange(g) * wb).astype(np.int64)
                by = (clipped.reshape(-1, g) << shifts).sum(axis=-1)
                out.append(by.astype(np.uint8).tobytes())
            else:
                shifts = (np.arange(8) * 3).astype(np.int64)
                w24 = (clipped.reshape(-1, 8) << shifts).sum(axis=-1)
                by = np.stack(
                    [w24 & 255, (w24 >> 8) & 255, (w24 >> 16) & 255], axis=-1
                )
                out.append(by.astype(np.uint8).tobytes())

    # exceptions: block-major (global element order)
    thr_t = np.where(width > 0, (1 << width) - 1, 1 << 30)  # (T, bs)
    thr_bm = np.broadcast_to(thr_t[:, None, :], (t, b, bs)).reshape(
        t * b, bs
    )[:nblk]
    exc_mask = nib_bm >= thr_bm
    exc = ids_i[exc_mask].astype(np.uint8)
    cw = chunk_width(nblk * bs, bs)
    counts = exc_mask.reshape(-1, cw).sum(axis=-1)
    return width.astype(np.uint8), b"".join(out), exc.tobytes(), counts
