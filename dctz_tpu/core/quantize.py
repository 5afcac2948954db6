"""Adaptive quantization of DCT coefficients (EC and QT modes).

Reference hot loops re-expressed as whole-array tensor algebra:
  * pass 1 — bin assignment / escape detection (dctz-comp-lib.c:325-416)
  * QT quantizer-table build (dctz-comp-lib.c:355-398,450-461)
  * pass 2 — outlier handling: EC verbatim save (dctz-comp-lib.c:534-541),
    QT renormalization (dctz-comp-lib.c:471-533)
  * decode — dequantization + AC restore (dctz-decomp-lib.c:389-483)

Everything is elementwise work plus one cumsum + scatter for the
variable-length AC_exact compaction; no data-dependent shapes appear on the
device (the compacted stream lives in a fixed-capacity buffer, its true
length is a scalar output).

Faithful quirks preserved:
  * DC positions are marked with the escape id in bin_index but never consume
    an AC_exact slot (dctz-comp-lib.c:361 vs dctz-decomp-lib.c:392-396).
  * DC and AC_exact streams are float32 even for float64 data (USE_TRUNCATE,
    dctz-comp-lib.c:102-105,351,537).
  * qtable[0] holds the DC coefficient of the LAST block (dctz-comp-lib.c:
    355-360 overwrites it every iteration) and is excluded from the >=1.0
    clamp (dctz-comp-lib.c:450-461).
  * The reference's C-mixed-precision float path (float values combined with
    the double error bound, e.g. dctz-comp-lib.c:515) is reproduced by doing
    the QT renormalization in float64 when x64 is enabled.

Deliberate deviation: a scaled coefficient exactly equal to +range_max maps
to linear bin 255 in the reference and reads past conv_tbl (undefined
behavior); we clamp to bin nbins-1, whose center is one bin width away —
still within the error bound.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import CodecConfig
from . import constants as C
from .binning import linear_to_zigzag, zigzag_to_center


class Quantized(NamedTuple):
    """Device-side result of quantizing one array's DCT coefficients.

    The AC stream is globally compacted: ac_buf (capacity,) holds the
    escaped coefficients in row-major order, ac_count is their number."""

    bin_ids: jax.Array  # (nblk, bs) uint8; padding & DC slots hold ESCAPE
    dc: jax.Array  # (nblk,) float32 (truncate=True) or input dtype
    ac_buf: jax.Array  # (capacity,) escaped coefficients, zeros past count
    ac_count: jax.Array  # scalar int32
    qtable: jax.Array | None  # (bs,) QT mode only
    bound_ok: jax.Array | None = None  # verify-repair outcome (cfg.verify)


def _work_dtype(dtype) -> jnp.dtype:
    """float64 when available — mirrors C's double intermediates in the
    float path (e.g. dctz-comp-lib.c:515: float op double -> double)."""
    if jax.config.jax_enable_x64:
        return jnp.float64
    return jnp.dtype(dtype)


def _geometry(cfg: CodecConfig, dtype):
    """Static bin geometry constants in the arithmetic dtype.

    Computed in double then rounded once, matching the C assignments at
    dctz-comp-lib.c:271-281 / dctz-decomp-lib.c:372-381.
    """
    eb = float(cfg.error_bound)
    half = cfg.nbins // 2
    w_d = eb * 2.0 * cfg.brsf
    rmax_d = (half * 2 + 1) * (eb * cfg.brsf)
    return (
        jnp.asarray(np.array(w_d, dtype)),
        jnp.asarray(np.array(-rmax_d, dtype)),
        jnp.asarray(np.array(rmax_d, dtype)),
    )


def _masks(nblk: int, bs: int, n: int):
    """(valid, ac) masks over the padded (nblk, bs) coefficient grid.

    valid: position maps to a real input element (tail block is partial).
    ac: valid AND j >= 1 (j = 0 is the DC slot, dctz-comp-lib.c:361).
    """
    row = jax.lax.broadcasted_iota(jnp.int32, (nblk, bs), 0)
    col = jax.lax.broadcasted_iota(jnp.int32, (nblk, bs), 1)
    valid = row * bs + col < n
    return valid, valid & (col >= 1)


def _assign_bins(coeffs, rmin, rmax, w, nbins):
    """Pass-1 bin assignment: (in_range, zigzag ids) (dctz-comp-lib.c:363-414)."""
    in_range = (coeffs >= rmin) & (coeffs <= rmax)
    lin = jnp.clip(
        ((coeffs - rmin) / w).astype(jnp.int32), 0, nbins - 1
    )
    ids = linear_to_zigzag(lin, nbins)
    return in_range, ids


def _compact(flat_mask: jax.Array, flat_vals: jax.Array, capacity: int):
    """Order-preserving compaction of masked values into a fixed buffer.

    Returns (buf (capacity,), count). Uses cumsum + scatter-drop so shapes
    stay static under jit; entries past `count` are zeros.
    """
    # the barrier keeps XLA from fusing the prefix sum (a reduce-window on
    # the GPU) into the scatter's index computation, where each element
    # would recompute its own window
    idx = jax.lax.optimization_barrier(
        jnp.cumsum(flat_mask.astype(jnp.int32)) - 1
    )
    pos = jnp.where(flat_mask, idx, capacity)  # out-of-range rows are dropped
    buf = jnp.zeros((capacity,), flat_vals.dtype).at[pos].set(
        flat_vals, mode="drop"
    )
    count = jnp.sum(flat_mask.astype(jnp.int32))
    return buf, count


def chunk_width(total: int, block_size: int) -> int:
    """Largest supported compaction chunk width dividing the padded size.

    Always a multiple of block_size: per-chunk escape counts assume every
    chunk holds whole blocks (one DC mark each — see api._chunk_escape_counts),
    so a chunk boundary must never split a block. `total` is a padded size and
    hence a block multiple itself.
    """
    from ..ops.compaction import CHUNK_W

    k = max(CHUNK_W // block_size, 1)
    while k > 1 and total % (k * block_size) != 0:
        k //= 2
    return k * block_size


def quantize(
    coeffs: jax.Array,
    n: int,
    cfg: CodecConfig,
    axis_name: str | None = None,
    promote: bool = True,
    ext_qtable: jax.Array | None = None,
):
    """Quantize padded block coefficients (nblk, bs); n is the true element
    count (static). Covers reference pass 1 + pass 2 for both modes.

    Returns (bin_ids (nblk, bs) uint8, stored (nblk, bs) values as the
    container stores them in place, dc (nblk,), qtable or None).

    axis_name: when running inside shard_map, the mesh axis to all-reduce the
    QT quantizer table over — the table must see pass-1 maxima from ALL
    shards before pass 2 (a ~512-byte `lax.pmax`; the only cross-device
    communication besides the scaling factor).

    ext_qtable: externally reduced per-position |escaped coef| maxima
    (slots >= 1; slot 0 ignored) — the segmented stream writer's GLOBAL
    qtable (stream.compress_stream runs pass 1 over every segment first,
    so each frame renormalizes against the whole-array table exactly like
    the monolithic two-pass). Slot 0 is patched with THIS array's last
    block DC (the reference quirk; the decoder never reads it)."""
    nblk, bs = coeffs.shape
    dtype = coeffs.dtype
    w, rmin, rmax = _geometry(cfg, np.dtype(dtype.name))
    valid, ac_mask = _masks(nblk, bs, n)

    in_range, ids = _assign_bins(coeffs, rmin, rmax, w, cfg.nbins)

    stored_dtype = jnp.float32 if cfg.truncate else dtype
    dc = coeffs[:, 0].astype(stored_dtype)

    binned = ac_mask & in_range  # regular-bin AC coefficients
    escape = ac_mask & ~in_range  # out-of-range AC coefficients
    qtable = None

    if cfg.mode == "qt":
        if ext_qtable is not None:
            qtable = jnp.maximum(
                ext_qtable.astype(dtype), jnp.asarray(1.0, dtype)
            )
            qtable = qtable.at[0].set(coeffs[-1, 0].astype(dtype))
        else:
            # Per-position max |coef| over escaped entries (dctz-comp-lib.c:
            # 355-398), clamped to >= 1.0 for j >= 1 (dctz-comp-lib.c:450-461).
            col_max = jnp.max(
                jnp.where(escape, jnp.abs(coeffs), jnp.zeros_like(coeffs)),
                axis=0,
            )
            # qtable[0] = DC of the last block (faithful reference quirk);
            # sharded runs take the pmax over shards' last-block DCs instead
            # (decoder never reads slot 0, dctz-decomp-lib.c:396-413).
            col_max = col_max.at[0].set(coeffs[-1, 0])
            if axis_name is not None:
                col_max = jax.lax.pmax(col_max, axis_name)
            qtable = jnp.maximum(col_max, jnp.asarray(1.0, dtype))
            qtable = qtable.at[0].set(col_max[0])

        # Pass 2: renormalize outliers toward the bin range edge
        # (dctz-comp-lib.c:484-533). C mixes float with the double error
        # bound, so run in the widest available dtype and round once.
        # promote=False keeps the value dtype.
        wd = _work_dtype(dtype) if promote else dtype
        side = jnp.where(coeffs > rmax, rmax, rmin).astype(wd)
        qrow = qtable.astype(wd)[None, :]
        norm = (
            (coeffs.astype(wd) / qrow) * jnp.asarray(float(cfg.error_bound), wd)
        ) * jnp.asarray(cfg.qt_factor, wd) + side
        norm = norm.astype(dtype)  # C assigns back to the value's own type
        coeffs = jnp.where(escape, norm, coeffs)

        # Re-test: renormalized values that landed inside the range are
        # re-binned (dctz-comp-lib.c:494-506,520-529). In practice they all
        # stay outside (the normalized magnitude exceeds the range edge),
        # but the check is faithful.
        re_in, re_ids = _assign_bins(coeffs, rmin, rmax, w, cfg.nbins)
        ids = jnp.where(escape & re_in, re_ids, ids)
        binned = binned | (escape & re_in)

    # bin_index stream: escape marks at DC slots and escaped ACs; padding
    # positions also read ESCAPE for determinism (sliced off at flatten).
    bin_ids = jnp.where(
        binned, ids, jnp.asarray(C.ESCAPE, jnp.int32)
    ).astype(jnp.uint8)
    return bin_ids, coeffs.astype(stored_dtype), dc, qtable


def encode(
    coeffs: jax.Array,
    n: int,
    cfg: CodecConfig,
    ac_capacity: int | None = None,
    axis_name: str | None = None,
    promote: bool = True,
    ext_qtable: jax.Array | None = None,
) -> Quantized:
    """quantize() followed by the global AC compaction; ac_capacity
    defaults to n (always lossless)."""
    bin_ids, stored, dc, qtable = quantize(
        coeffs, n, cfg, axis_name, promote, ext_qtable
    )
    return repack(bin_ids, stored, dc, qtable, n, ac_capacity)


def repack(
    bin_ids: jax.Array,
    dense_vals: jax.Array,
    dc: jax.Array,
    qtable: jax.Array | None,
    n: int,
    ac_capacity: int | None = None,
) -> Quantized:
    """Compact the AC stream from bin ids + in-place stored values (the
    quantize() or verify-repair output, ops/repair.py); the escape marks
    alone select the stream, everything else passes through."""
    nblk, bs = bin_ids.shape
    _, ac_mask = _masks(nblk, bs, n)
    escape = ac_mask & (bin_ids.astype(jnp.int32) == C.ESCAPE)
    ac_buf, ac_count = _compact(
        escape.reshape(-1),
        dense_vals.reshape(-1),
        ac_capacity if ac_capacity is not None else n,
    )
    return Quantized(bin_ids, dc, ac_buf, ac_count, qtable)


def decode(
    bin_ids: jax.Array,
    dc: jax.Array,
    ac_buf: jax.Array,
    qtable: jax.Array | None,
    n: int,
    cfg: CodecConfig,
    dtype,
    ac_layout: str = "chunked",
) -> jax.Array:
    """Rebuild padded (nblk, bs) coefficients (dctz-decomp-lib.c:389-483).

    bin_ids: (nblk, bs) uint8 (padding slots must hold ESCAPE or anything —
    they are masked); dc: (nblk,); ac_buf: the escaped-coefficient stream as
    per-chunk padded rows (nchunks, capc) (ac_layout="chunked": every
    decoder's layout, ops/compaction.py), or a full (nblk, bs) grid holding
    stored values in place (ac_layout="dense" — used by the encode-side
    verifier, which has the values at their positions and skips the
    compaction round trip; the arithmetic is identical)."""
    nblk, bs = bin_ids.shape
    w, rmin, rmax = _geometry(cfg, np.dtype(jnp.dtype(dtype).name))
    _, ac_mask = _masks(nblk, bs, n)

    ids = bin_ids.astype(jnp.int32)
    escape = ac_mask & (ids == C.ESCAPE)

    # Restore escaped coefficients: the k-th escape (row-major) reads the
    # k-th AC stream entry.
    if ac_layout == "dense":
        ac_vals = ac_buf
    else:
        from ..ops import compaction as cp

        cw = (nblk * bs) // ac_buf.shape[0]
        mask2 = escape.reshape(-1, cw)
        ac_vals = cp.expand_chunked(mask2, ac_buf).reshape(nblk, bs)
    ac_vals = ac_vals.astype(dtype)  # float32 -> working dtype (USE_TRUNCATE)

    if cfg.mode == "qt" and qtable is not None:
        # Invert the renormalization by the sign of the stored value
        # (dctz-decomp-lib.c:401-413). C divides a float by the double
        # eb*qt_factor, so use the widest dtype and round once.
        wd = _work_dtype(dtype)
        denom = jnp.asarray(float(cfg.error_bound), wd) * jnp.asarray(
            cfg.qt_factor, wd
        )
        side = jnp.where(ac_vals > 0, rmax, rmin).astype(wd)
        qrow = qtable.astype(wd)[None, :]
        ac_vals = (
            ((ac_vals.astype(wd) - side) / denom) * qrow
        ).astype(dtype)

    centers = zigzag_to_center(ids, w.astype(dtype))
    coeffs = jnp.where(escape, ac_vals, centers)
    coeffs = coeffs.at[:, 0].set(dc.astype(dtype))
    return coeffs
