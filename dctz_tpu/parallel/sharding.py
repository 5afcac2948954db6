"""Multi-device scaling: `shard_map` pipeline over a 1-D device mesh.

The reference has NO distributed capability (its only concurrency is three
deflate pthreads, dctz-comp-lib.c:620-732); sharded compression is the new
capability this rebuild adds (SURVEY.md §2 "parallelism strategies").

Design (pick a mesh, annotate shardings, let XLA insert collectives):

  * 1-D mesh axis "data": the flat array is block-sharded in multiples of
    BLK_SZ, so DCT blocks NEVER cross shard boundaries — the per-shard
    pipeline (scale -> DCT matmul -> quantize -> compact) is entirely local.
    The mesh follows the algorithm alone: every device of a host reaches
    every other at the same rate.
  * Two tiny collectives cross devices:
      - `lax.pmax` of the local max|x| (8 bytes) -> global scaling factor;
      - QT mode only: `lax.pmax` of the 64-entry quantizer table (512 B),
        which must see pass-1 maxima from all shards before pass 2.
    The mean needs a `lax.psum` (8 bytes) for the container header.
  * Everything else stays shard-local; compressed segments gather to hosts
    (device->host copies) where the entropy stage runs.
  * TP/PP/EP analogs: N/A for this workload — there is no model to partition;
    "sequence parallelism" maps to this array-length sharding (SURVEY.md §5).

The input is zero-padded to a multiple of n_devices * BLK_SZ: zero blocks
produce DC=0 and all-center bin ids, which deflate to almost nothing, and
zeros never perturb max|x| or escape counts. The container records the true
element count; the decoder derives the padded length from the bin_index
stream itself.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import CodecConfig
from .. import backend
from ..core import quantize as qz
from ..core import transform
from ..core.stats import scaling_factor

AXIS = "data"


def make_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or the given) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (AXIS,))


def padded_size(
    n: int, n_devices: int, block_size: int, quantum_blocks: int = 1
) -> int:
    quantum = n_devices * block_size * quantum_blocks
    return -(-n // quantum) * quantum


def _local_encode(x_local, n_real, cfg, axis_name):
    """Per-shard pipeline body (runs inside shard_map)."""
    amax = jax.lax.pmax(jnp.max(jnp.abs(x_local)), axis_name)
    total = jax.lax.psum(jnp.sum(x_local, dtype=x_local.dtype), axis_name)
    mean = total / jnp.asarray(n_real, x_local.dtype)
    sf = scaling_factor(amax, cfg.sf_adj)

    xs = x_local / sf
    n_local = xs.shape[0]  # multiple of block_size by construction
    coeffs = transform.block_dct_flat(
        xs, cfg.block_size, precision=backend.dct_precision(cfg.dct_precision)
    )
    q = qz.encode(coeffs, n_local, cfg, axis_name=axis_name)
    ok = jnp.bool_(True)
    if cfg.verify:
        # pointwise tolerance needs the GLOBAL value range over real
        # elements only — two more 8-byte pmax/pmin; the repair
        # itself is entirely shard-local (blocks never cross shards).
        from ..ops import repair

        idx = jax.lax.axis_index(axis_name)
        gpos = idx * n_local + jnp.arange(n_local)
        real = gpos < n_real
        vmax = jax.lax.pmax(
            jnp.max(jnp.where(real, x_local, -jnp.inf)), axis_name
        )
        vmin = jax.lax.pmin(
            jnp.min(jnp.where(real, x_local, jnp.inf)), axis_name
        )
        tol = (
            (vmax - vmin)
            * jnp.asarray(cfg.error_bound, x_local.dtype)
            * repair._SLACK
        )
        n_valid_local = jnp.clip(n_real - idx * n_local, 0, n_local)
        ids2, dense, ok = repair.verify_repair(
            x_local,
            coeffs,
            sf,
            q.bin_ids,
            q.dc,
            q.qtable,
            n_local,
            n_valid_local,
            cfg,
            tol,
        )
        ok = jax.lax.pmin(ok.astype(jnp.int32), axis_name).astype(jnp.bool_)
        q = qz.repack(ids2, dense, q.dc, q.qtable, n_local)
    return q, sf, mean, ok


@functools.partial(
    jax.jit, static_argnames=("n_real", "cfg", "mesh", "dpk", "cape")
)
def encode_sharded(
    x_padded,
    *,
    n_real: int,
    cfg: CodecConfig,
    mesh: Mesh,
    dpk: bool = False,
    cape: int | None = None,
):
    """Sharded compression device program.

    x_padded: (n_pad,) zero-padded to a multiple of n_devices * block_size,
    sharded (or shardable) over the mesh. Returns globally-assembled views:
    bin_ids (n_pad/bs, bs), dc (n_pad/bs,), the AC stream as per-shard
    (n_dev, shard) buffers + (n_dev,) counts, plus replicated sf / mean /
    qtable / verify flag.

    dpk=True additionally runs the per-shard device id-stream coder
    (ops/idpack.py) and appends (widths, packed rows, exception rows,
    exception counts, AC chunk counts, exception overflow): every array is
    tile-/chunk-major along the shard axis, so the P(AXIS) outputs ARE the
    single-device global layout — no reordering anywhere. Requires the shard
    length to be a multiple of block_size * idpack.B_DEFAULT.
    """
    qt = cfg.mode == "qt"

    def body(x_local):
        q, sf, mean, ok = _local_encode(x_local, n_real, cfg, AXIS)
        qtable = q.qtable if qt else jnp.zeros((cfg.block_size,), x_local.dtype)
        out = (
            q.bin_ids, q.dc, q.ac_buf[None, :], q.ac_count[None], sf, mean,
            qtable, ok,
        )
        if not dpk:
            return out
        from ..ops import idpack

        # n_valid = the WHOLE shard: blocks are full zero-padded 64-point
        # transforms here, so every coefficient position is meaningful
        # (masking by the true element count would zero real coefficients
        # of the last partial block). Pure-padding blocks are all id 0 and
        # pack to nothing anyway.
        n_local = x_local.shape[0]
        width, packed, exc_rows, exc_counts, exc_ovf = idpack.pack_ids(
            q.bin_ids, n_local, idpack.B_DEFAULT, cape or idpack.CAPE
        )
        cw = qz.chunk_width(n_local, cfg.block_size)
        ac_counts = idpack.ac_chunk_counts(q.bin_ids, n_local, cw)
        exc_ovf = jax.lax.pmax(exc_ovf.astype(jnp.int32), AXIS)
        return out + (width, packed, exc_rows, exc_counts, ac_counts, exc_ovf)

    specs = [P(AXIS)] * 4 + [P()] * 4
    if dpk:
        specs += [P(AXIS)] * 5 + [P()]
    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=P(AXIS),
        out_specs=tuple(specs),
    )(x_padded)


@functools.partial(
    jax.jit, static_argnames=("n_pad", "cfg", "dtype", "mesh")
)
def decode_sharded(
    bin_ids,
    dc,
    ac_rows,
    sf,
    qtable,
    *,
    n_pad: int,
    cfg: CodecConfig,
    dtype: str,
    mesh: Mesh,
):
    """Sharded decompression device program.

    bin_ids: (n_pad/bs, bs) sharded over rows. ac_rows: the AC stream as
    per-chunk padded rows (n_pad/cw, capc), cw dividing the shard length, so
    each shard holds the rows of its own chunks. Returns the flat
    reconstructed padded array, sharded over the mesh.
    """

    def body(ids_local, dc_local, ac_local, sf_rep, qtable_rep):
        n_local = ids_local.shape[0] * ids_local.shape[1]
        coeffs = qz.decode(
            ids_local,
            dc_local,
            ac_local,
            qtable_rep if cfg.mode == "qt" else None,
            n_local,
            cfg,
            jnp.dtype(dtype),
        )
        x = transform.block_idct_flat(coeffs)
        return x * sf_rep.astype(x.dtype)

    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P(AXIS), P(), P()),
        out_specs=P(AXIS),
    )(bin_ids, dc, ac_rows, sf, qtable)


@functools.partial(
    jax.jit,
    static_argnames=("tile_b", "cw", "cfg", "dtype", "mesh"),
)
def decode_sharded_dpk(
    width,
    rows,
    exc_rows,
    dc,
    ac_rows,
    sf,
    qtable,
    *,
    tile_b: int,
    cw: int,
    cfg: CodecConfig,
    dtype: str,
    mesh: Mesh,
):
    """Sharded decompression of a device-packed (DPK) container.

    Every DPK input is tile-/chunk-major along the global position axis
    (width: one row per tile; rows: bs packed rows per tile; exc_rows /
    ac_rows: tile_b*bs/cw chunk rows per tile; dc: tile_b entries per
    tile), so block-sharding the leading axes over the mesh hands each
    shard whole tiles and decode is entirely shard-local — the only
    replicated operands are the 4-byte sf and the QT qtable. The caller
    pads to a tile multiple of n_devices (synthetic zero tiles decode to
    zero blocks: width 0 rows unpack to all-center ids and consume no
    exceptions). Per shard the same program as the single-device path runs:
    unpack (ops/idpack.py) + the XLA decode chain."""
    from ..ops import idpack

    bs = cfg.block_size
    n_dev = mesh.devices.size
    t_l = width.shape[0] // n_dev
    n_local = t_l * tile_b * bs

    def body(w_l, p_l, e_l, dc_l, ac_l, sf_rep, qt_rep):
        qt = qt_rep if cfg.mode == "qt" else None
        bin_ids = idpack.unpack_ids(
            w_l, p_l, e_l, n_local // bs, bs, tile_b, cw
        )
        coeffs = qz.decode(
            bin_ids, dc_l, ac_l, qt, n_local, cfg, jnp.dtype(dtype)
        )
        x = transform.block_idct_flat(coeffs)
        return x * sf_rep.astype(x.dtype)

    qt_in = (
        qtable
        if qtable is not None
        else jnp.zeros((cfg.block_size,), jnp.dtype(dtype))
    )
    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(AXIS),) * 5 + (P(), P()),
        out_specs=P(AXIS),
    )(width, rows, exc_rows, dc, ac_rows, sf, qt_in)


def shard_input(
    x: np.ndarray, mesh: Mesh, block_size: int, quantum_blocks: int = 1
):
    """Zero-pad and device_put a host array sharded over the mesh.

    quantum_blocks > 1 aligns every shard to that many whole blocks (the
    DPK id coder needs shards to hold whole idpack.B_DEFAULT-block tiles)."""
    n = x.shape[0]
    n_dev = mesh.devices.size
    n_pad = padded_size(n, n_dev, block_size, quantum_blocks)
    if n_pad != n:
        x = np.concatenate([x, np.zeros(n_pad - n, x.dtype)])
    sharding = NamedSharding(mesh, P(AXIS))
    return jax.device_put(x, sharding), n_pad


def shard_input_device(
    x: jax.Array,
    mesh: Mesh,
    block_size: int,
    quantum_blocks: int = 1,
    promote_f32: bool = False,
):
    """Device-resident counterpart of shard_input: flatten, optionally
    promote f64 -> f32, zero-pad, and reshard over the mesh WITHOUT the
    input ever visiting the host (VERDICT round-3 #4 — a multi-TB
    device-resident array must not round-trip through one host's RAM).
    XLA inserts the device-to-device collectives for the reshard."""
    n = int(np.prod(x.shape))
    n_dev = mesh.devices.size
    n_pad = padded_size(n, n_dev, block_size, quantum_blocks)
    spec = NamedSharding(mesh, P(AXIS))

    @functools.partial(
        jax.jit, static_argnums=(1, 2), out_shardings=spec
    )
    def prep(x, n_pad, promote):
        x = x.reshape(-1)
        if promote and x.dtype == jnp.float64:
            x = x.astype(jnp.float32)
        if n_pad != x.shape[0]:
            x = jnp.concatenate(
                [x, jnp.zeros((n_pad - x.shape[0],), x.dtype)]
            )
        return x

    return prep(x, n_pad, promote_f32), n_pad
