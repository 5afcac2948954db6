"""Public compress / decompress API.

Reference counterparts: dctz_compress (dctz-comp-lib.c:90-846) and
dctz_decompress (dctz-decomp-lib.c:51-548). The orchestration is split:

  device (one jitted XLA program each way):
      stats -> scale -> batched-matmul block DCT -> quantize -> AC compaction
      (compress), and the exact mirror for decompress. Everything is static-
      shaped; the variable-length AC stream lives in a fixed-capacity buffer
      whose true length is a scalar output.
  host (thread pool / native extension):
      zlib entropy stage + container assembly, overlapped across streams like
      the reference's three pthreads (dctz-comp-lib.c:620-732).

The jitted programs are cached per (shape, dtype, config).
"""

from __future__ import annotations

import dataclasses
import functools
import struct
import warnings
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from . import backend
from .config import CodecConfig
from .core import constants as C
from .core import container as ct
from .core import entropy
from .core import quantize as qz
from .core import transform
from .core.stats import calc_data_stat


def _device_cfg(cfg: CodecConfig) -> CodecConfig:
    """Normalize host-only fields so the jit cache keys on device-relevant
    geometry only (container/zlib/shuffle settings must not trigger device
    recompiles)."""
    return dataclasses.replace(
        cfg,
        zlib_level=6,
        ids_zlib_level=None,
        container="v1",
        shuffle=False,
        ids4=True,
        ids_codec="auto",
        dpk_host_codec="none",
        host_codec="auto",
        chunk_bytes=1 << 22,
        internal_dtype="auto",
        segment_elems=None,
        dc_delta=False,
    )


def _zstd_on(cfg: CodecConfig) -> bool:
    """True when the v2 host stage should use the zstd backend."""
    return cfg.host_codec == "auto" and entropy.zstd_available()


def _pad_coeffs(main_c: jax.Array, tail_c: jax.Array, block_size: int) -> jax.Array:
    """Stack main blocks and the (padded) remainder block into (nblk, bs)."""
    if tail_c.shape[0] == 0:
        return main_c
    pad = jnp.zeros((block_size - tail_c.shape[0],), main_c.dtype)
    tail_row = jnp.concatenate([tail_c, pad])[None, :]
    return jnp.concatenate([main_c, tail_row], axis=0)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _encode_device(x: jax.Array, n: int, cfg: CodecConfig):
    """Full device-side compression pipeline (scale+DCT+quantize+compact),
    optionally followed by the in-program verify-repair pass (cfg.verify)."""
    stats = calc_data_stat(x, cfg.sf_adj)
    xs = x / stats.sf  # reference divides in place (dctz-comp-lib.c:198)
    main_c, tail_c = transform.forward(
        xs, cfg.block_size, precision=backend.dct_precision(cfg.dct_precision)
    )
    coeffs = _pad_coeffs(main_c, tail_c, cfg.block_size)
    q = qz.encode(coeffs, n, cfg)
    if cfg.verify:
        from .ops import repair

        ids2, dense32, ok = repair.verify_repair(
            x, coeffs, stats.sf, q.bin_ids, q.dc, q.qtable, n, n, cfg
        )
        q = qz.repack(ids2, dense32, q.dc, q.qtable, n)
        q = q._replace(bound_ok=ok)
    return q, stats


def _assemble_ac(q: qz.Quantized) -> tuple[np.ndarray, np.ndarray, int]:
    """Host-side AC stream assembly. Returns (ac_stream, bin_ids,
    total_count)."""
    bin_ids, ac_buf, ac_count = jax.device_get(
        (q.bin_ids, q.ac_buf, q.ac_count)
    )
    return ac_buf[: int(ac_count)], bin_ids, int(ac_count)


def _decode_core(bin_ids, dc, ac_rows, n, cfg, dtype, sf, qtable):
    """Shared device decode body: dequantize + IDCT + unscale. ac_rows: the
    AC stream as per-chunk padded rows (see backend.py for why decoders
    avoid a gather from the global stream)."""
    coeffs = qz.decode(bin_ids, dc, ac_rows, qtable, n, cfg, jnp.dtype(dtype))
    n_full = n // cfg.block_size
    rem = n % cfg.block_size
    main_c = coeffs[:n_full]
    tail_c = coeffs[n_full, :rem] if rem else jnp.zeros((0,), coeffs.dtype)
    x = transform.inverse(main_c, tail_c)
    return (x * sf.astype(x.dtype))[:n]


@functools.partial(jax.jit, static_argnums=(3, 4, 5, 6))
def _decode_device(
    bin_ids: jax.Array,
    dc: jax.Array,
    ac_rows: jax.Array,
    n: int,
    cfg: CodecConfig,
    dtype: str,
    sf_weak_type: bool,
    sf: jax.Array,
    qtable: jax.Array | None,
):
    """Full device-side decompression pipeline (dequantize+IDCT+unscale)."""
    del sf_weak_type  # part of the cache key only
    return _decode_core(bin_ids, dc, ac_rows, n, cfg, dtype, sf, qtable)


def _combine_planes(pl: jax.Array) -> jax.Array:
    """Inverse of _plane_split2 on device: (4, ...) u8 LE byte planes ->
    float32."""
    u = pl[0].astype(jnp.uint32)
    for k in range(1, pl.shape[0]):
        u = u | (pl[k].astype(jnp.uint32) << (8 * k))
    return jax.lax.bitcast_convert_type(u, jnp.float32)


def _f32_delta_dev(dc: jax.Array) -> jax.Array:
    """Device twin of entropy.f32_delta (bit-identical: exact u32
    arithmetic both places). XLA fuses it into the plane-split epilogue."""
    u = jax.lax.bitcast_convert_type(dc, jnp.uint32)
    m = jnp.where((u >> 31) != 0, ~u, u | jnp.uint32(0x80000000))
    n = m.shape[0]
    R = entropy.DC_RESTART
    k = -(-n // R)
    pad = k * R - n
    m2 = (jnp.pad(m, (0, pad)) if pad else m).reshape(k, R)
    d = jnp.concatenate([m2[:, :1], m2[:, 1:] - m2[:, :-1]], axis=1)
    d = d.reshape(-1)[:n]
    return jax.lax.bitcast_convert_type(d, jnp.float32)


def _f32_delta_inv_dev(dc: jax.Array) -> jax.Array:
    """Device twin of entropy.f32_delta_inv. Item 0 must sit on a restart
    boundary (decode slices are DPK-tile-aligned; tile_b == DC_RESTART)."""
    a = jax.lax.bitcast_convert_type(dc, jnp.uint32)
    n = a.shape[0]
    R = entropy.DC_RESTART
    k = -(-n // R)
    pad = k * R - n
    m2 = (jnp.pad(a, (0, pad)) if pad else a).reshape(k, R)
    m = jnp.cumsum(m2, axis=1).reshape(-1)[:n]
    u = jnp.where((m >> 31) != 0, m & jnp.uint32(0x7FFFFFFF), ~m)
    return jax.lax.bitcast_convert_type(u, jnp.float32)


@functools.partial(jax.jit, static_argnums=(5, 6, 7, 8, 9, 12))
def _decode_device_dpk(
    width: jax.Array,
    packed_rows: jax.Array,
    exc_rows: jax.Array,
    dc: jax.Array,
    ac_buf: jax.Array,
    n: int,
    cfg: CodecConfig,
    dtype: str,
    tile_b: int,
    cw: int,
    sf: jax.Array,
    qtable: jax.Array | None,
    dcd: bool = False,
):
    """Decompression from the device-packed id stream: the raw bin_index
    bytes never exist on the host. Unpack on device (ops/idpack.py), then
    the shared decode body. dc/ac_buf may arrive as (4, ...) uint8 BYTE
    PLANES (the PLC sections uploaded without the host unshuffle) —
    reassembled here, a cheap prologue XLA fuses away."""
    from .ops import idpack

    if dc.dtype == jnp.uint8:
        dc = _combine_planes(dc)
    if ac_buf.dtype == jnp.uint8:
        ac_buf = _combine_planes(ac_buf)
    if dcd:  # container.Header.dcd: DC section stores u32 deltas
        dc = _f32_delta_inv_dev(dc)
    nblk = -(-n // cfg.block_size)
    bin_ids = idpack.unpack_ids(
        width, packed_rows, exc_rows, nblk, cfg.block_size, tile_b, cw
    )
    return _decode_core(bin_ids, dc, ac_buf, n, cfg, dtype, sf, qtable)


@functools.partial(jax.jit, static_argnums=(2,))
def _plane_split2(dc: jax.Array, ac: jax.Array, dcd: bool = False):
    """Byte-plane split of the f32 DC/AC streams ON DEVICE: plane k is the
    k-th little-endian byte of each item — exactly entropy.shuffle_bytes'
    layout, so the host-side PLC sections come out byte-identical while
    the host skips its shuffle pass entirely (the decode-side unshuffle is
    unchanged). XLA fuses this into a cheap epilogue.

    dcd: delta-code the DC stream first (_f32_delta_dev; the host packer
    sets container.Header.dcd via _float_sections_planes)."""

    def split(a):
        u = jax.lax.bitcast_convert_type(a, jnp.uint32)
        return jnp.stack(
            [(u >> (8 * k)).astype(jnp.uint8) for k in range(4)]
        )

    if dcd:
        dc = _f32_delta_dev(dc)
    return split(dc), split(ac)


def _dcd_on(cfg: CodecConfig, header: ct.Header) -> bool:
    """DC delta coding applies to v2 float32 containers when the OPT-IN
    cfg.dc_delta is set (default off — measured a wash on ratio, see
    config.py). f64 containers keep raw DC (the delta is
    u32-item); v1 keeps the reference byte layout (docs/parity.md)."""
    return (
        cfg.dc_delta
        and cfg.container == "v2"
        and header.dtype == np.float32
    )


def _float_sections_planes(
    planes, cfg: CodecConfig, header: ct.Header, dc_delta: bool = False
):
    """_float_sections for device-split byte planes (u8 arrays).

    dc_delta: the device already delta-coded this (DC) stream before the
    split (_plane_split2) — just record the flag."""
    header.plc = True
    if dc_delta:
        header.dcd = True
    return entropy.encode_float_planes(
        list(planes), cfg.chunk_bytes, cfg.zlib_level,
        use_zlib=not _zstd_on(cfg),
    )


def _plane_mode(cfg: CodecConfig, dc_dev) -> bool:
    """Device plane split applies when the host stage would PLC-shuffle a
    float32 stream anyway (the flagship v2 layout)."""
    return (
        cfg.float_codec == "plane"
        and cfg.shuffle
        and dc_dev.dtype == jnp.float32
    )


def _pack_dpk_v2(
    header, width, packed_rows, exc_rows, exc_counts, counts, ac_chunks,
    dc, n_pad, cfg, qtable, *, dc_planes=None, ac_planes=None,
) -> bytes:
    """Host assembly of a DPK v2 container from the device outputs of the
    segmented stream writer (stream._pack_segment_dpk). The six sections
    are independent: DC and AC (including the AC row gather) code on the
    section pool while the four id sections code here — byte-identical
    output, assembly order is fixed at the gather below
    (the sequential section chain left most of the host cores idle). dc_planes/ac_planes: device-split byte planes
    (_plane_split2) replacing dc/ac_chunks — same bytes, no host
    shuffle."""
    from .core.quantize import chunk_width
    from .ops import idpack

    header.shuffle = cfg.shuffle
    pool = entropy.section_pool()

    def _ac_task():
        if ac_planes is not None:
            # ONE row-gather over the stacked planes (lens tiled): the
            # output concatenates the tight planes in order — 4x fewer
            # native-call row loops than per-plane gathers (measured
            # 2.2 -> ~0.8 ms on the bench AC section)
            k, nch, capc = ac_planes.shape
            flat = entropy.take_row_prefixes(
                ac_planes.reshape(k * nch, capc), np.tile(counts, k)
            )
            per = flat.size // k
            tight = [flat[i * per : (i + 1) * per] for i in range(k)]
            return _float_sections_planes(tight, cfg, header)
        ac = entropy.take_row_prefixes(ac_chunks, counts)
        return _float_sections(ac.tobytes(), ac.dtype.itemsize, cfg, header)

    if dc_planes is not None:
        f_dc = pool.submit(
            _float_sections_planes, list(dc_planes), cfg, header,
            _dcd_on(cfg, header),
        )
    else:
        f_dc = pool.submit(
            _float_sections, dc.tobytes(), dc.dtype.itemsize, cfg, header,
            True,
        )
    f_ac = pool.submit(_ac_task)
    streams = _dpk_sections(
        width,
        packed_rows,
        exc_rows,
        exc_counts,
        counts,
        idpack.B_DEFAULT,
        chunk_width(n_pad, cfg.block_size),
        n_pad,
        cfg,
        header,
    ) + (f_dc.result(), f_ac.result())
    return ct.pack_v2(header, streams, qtable, cfg.chunk_bytes)


def _ids_streams(ids_bytes: bytes, cfg: CodecConfig, header: ct.Header):
    """Deflated section(s) for the bin-index stream: (packed[, exceptions])
    with the IDS4 nibble filter, or the raw stream."""
    if not cfg.ids4:
        level = cfg.ids_zlib_level or cfg.zlib_level
        return (entropy.chunked_deflate(ids_bytes, cfg.chunk_bytes, level),)
    header.ids4 = True
    packed, exc = entropy.pack_ids4(ids_bytes)
    from . import native

    # exceptions: their long escape-runs (255s) favor LZ matches over
    # order-0 coding — chunk-zstd when available (2-4x faster than deflate
    # at the same size), else deflate level 1 (~2x faster than 5 for +0.2%
    # of total size; an explicit ids_zlib_level overrides).
    header.zst = cfg.ids_zlib_level is None and _zstd_on(cfg)
    exc_sec = (
        entropy.chunked_zstd(exc, cfg.chunk_bytes, 1)
        if header.zst
        else entropy.chunked_deflate(
            exc, cfg.chunk_bytes, cfg.ids_zlib_level or 1
        )
    )
    if cfg.ids_codec == "rans" or (
        cfg.ids_codec == "auto" and native.available()
    ):
        # native static rANS on the packed nibbles (~480 MB/s at better
        # ratio than zlib-huffman, which LZ does not improve on)
        header.rans = True
        return ([native.rans_compress(packed)], exc_sec)
    # packed nibbles: LZ matches add nothing beyond huffman (measured)
    return (
        entropy.chunked_deflate(
            packed, cfg.chunk_bytes, 1, entropy.HUFFMAN_ONLY
        ),
        exc_sec,
    )


def _float_sections(
    raw: bytes, isz: int, cfg: CodecConfig, header: ct.Header,
    dc: bool = False,
) -> list[bytes]:
    """v2 section chunks for a DC/AC float stream. float_codec="plane" codes
    each byte plane by its cheapest method (raw for near-random mantissa
    planes — skipping deflate entirely is the fast path); "deflate" keeps the
    whole-stream shuffle+deflate sections.

    dc=True: this is the DC section — delta-code it first when _dcd_on
    (lossless u32 deltas; the decoder inverts on header.dcd)."""
    if dc and isz == 4 and _dcd_on(cfg, header):
        raw = entropy.f32_delta(np.frombuffer(raw, np.float32)).tobytes()
        header.dcd = True
    if cfg.float_codec == "plane":
        header.plc = True
        return entropy.encode_float_stream(
            raw,
            isz if cfg.shuffle else 1,
            cfg.chunk_bytes,
            cfg.zlib_level,
            use_zlib=not _zstd_on(cfg),
        )
    if cfg.shuffle:
        raw = entropy.shuffle_bytes(raw, isz)
    return entropy.chunked_deflate(raw, cfg.chunk_bytes, cfg.zlib_level)


def _decode_float_section(header: ct.Header, chunks, dc: bool = False) -> bytes:
    """Inverse of _float_sections (branching on the container flags).

    dc=True inverts the DC delta (header.dcd) HOST-side — for the generic
    XLA decode path. The DPK decode paths keep the deltas through the host
    stage and invert on DEVICE (_decode_device_dpk dcd=True) instead."""
    if header.plc:
        raw = entropy.decode_float_stream(chunks)
    else:
        raw = entropy.chunked_inflate(chunks)
        if header.shuffle:
            raw = entropy.unshuffle_bytes(raw, header.stored_dtype.itemsize)
    if dc and header.dcd:
        raw = entropy.f32_delta_inv(np.frombuffer(raw, np.float32)).tobytes()
    return raw


def _float_section_range(header: ct.Header, chunks, i0: int, i1: int):
    """Items [i0, i1) of a float section as BYTE PLANES, decoding only the
    chunks each plane needs (entropy.decode_float_planes item_range) — the
    multi-host slice decode's DC/AC path. Non-PLC or non-f32 sections fall
    back to a full decode ("bytes", ...)."""
    if header.plc and chunks[0][0] == 4:  # directory byte 0 = itemsize
        planes, _isz = entropy.decode_float_planes(
            chunks, item_range=(i0, i1)
        )
        return ("planes", planes)
    return ("bytes", _decode_float_section(header, chunks))


def _float_raw(header: ct.Header, chunks, planes_ok: bool):
    """_decode_float_section, or ("planes", [plane bytes]) when planes_ok
    and the section is a 4-byte-item PLC section — the device-plane decode
    path skips the host join+unshuffle (api._combine_planes reassembles on
    device)."""
    if planes_ok and header.plc:
        planes, itemsize = entropy.decode_float_planes(chunks)
        if itemsize == 4:
            return ("planes", planes)
        shuffled = b"".join(planes)
        return (
            shuffled
            if itemsize == 1
            else entropy.unshuffle_bytes(shuffled, itemsize)
        )
    return _decode_float_section(header, chunks)


# --- device-packed ids ("DPK", ids_codec="device") host glue ---------------

_DPK_META_FMT = "<QHH2x"  # n_stream (padded elements), tile_b, AC chunk width
_DPK_META_SIZE = struct.calcsize(_DPK_META_FMT)
_VERBATIM_CHUNK = 1 << 20  # split stored-verbatim sections for parallel crc
# (1 MiB: a ~10 MB packed section yields ~10 crc tasks for the 4-core pool
# instead of 3 at the old 4 MiB — measured ~0.8 ms off pack_v2)


def _dpk_pack_device(bin_ids_dev: jax.Array, n: int):
    """Run the device id-packing program with exception-capacity retry.

    Returns the device arrays (width, packed_rows, exc_rows, exc_counts)."""
    from .ops import idpack

    out = idpack.pack_ids(bin_ids_dev, n, idpack.B_DEFAULT, idpack.CAPE)
    if bool(jax.device_get(out[4])):
        # full-chunk-width capacity (pack_ids clamps): always lossless
        out = idpack.pack_ids(bin_ids_dev, n, idpack.B_DEFAULT, 1 << 20)
    return out[:4]


def _dpk_sections(
    width,
    packed_rows,
    exc_rows,
    exc_counts,
    ac_counts,
    tile_b,
    cw,
    n_stream,
    cfg,
    header,
):
    """Host assembly of the 4 DPK id sections: slice each fixed-capacity
    device row to its tight byte count (one threaded gather — the only host
    work proportional to the stream), code the small side streams, and set
    the container flags on `header`. The packed/exception/meta sections code
    concurrently on the section pool (byte-identical; flags are decided
    up front so no task mutates the header)."""
    from . import native
    from .ops import idpack

    header.dpk = True
    zs = _zstd_on(cfg)
    header.dpks = cfg.dpk_host_codec == "zstd" and entropy.zstd_available()
    header.dpkz = cfg.dpk_host_codec == "deflate"
    header.dpkr = cfg.dpk_host_codec == "rans" and native.available()
    width = np.asarray(width)
    packed_rows = np.asarray(packed_rows)
    exc_rows = np.asarray(exc_rows)
    exc_counts = np.asarray(exc_counts)
    lvl = cfg.ids_zlib_level or cfg.zlib_level
    # side-section codec flags, decided before the tasks run. zstd (when
    # available) covers width/meta/exceptions at every size — measured
    # faster than rANS AND deflate at equal-or-better ratio. The zlib
    # fallback keeps the old policy: large exception streams take the
    # native rANS (~6x faster than deflate for ~8% of its size); below
    # 256 KiB the per-chunk frequency tables don't amortize and deflate
    # wins both ways. An explicit ids_zlib_level opts into deflate.
    header.zst = cfg.ids_zlib_level is None and zs
    header.rans = (
        not header.zst
        and cfg.ids_zlib_level is None
        and int(exc_counts.sum()) >= (1 << 18)
        and native.available()
    )

    def _packed_task():
        bpr = idpack.packed_nbytes(width.reshape(-1), tile_b)
        tight = entropy.take_row_prefixes(packed_rows, bpr)
        if header.dpks:
            # the zstd ratio mode: chunk-parallel zstd-1 takes ~20% off
            # the (already device-coded) packed section at ~0.8 ms/MB
            # each way — strictly dominating dpkz/dpkr on every measured
            # stream of the earlier development host
            return entropy.chunked_zstd(tight.tobytes(), cfg.chunk_bytes, 1)
        if header.dpkz:
            # optional ratio mode: the packed tiles of smooth data repeat,
            # so a cheap level-1 pass still halves the dominant section
            return entropy.chunked_deflate(
                tight.tobytes(), cfg.chunk_bytes, 1
            )
        if header.dpkr:
            # the light ratio mode: order-0 rANS takes ~12% off the packed
            # section at ~5x the deflate speed both ways (bench: 17 ms enc /
            # 24 ms dec per 9 MB vs deflate-1's 83 ms for 18%)
            return [native.rans_compress(tight)]
        # device-coded: stored verbatim (zero-copy memoryviews into the
        # gathered array; pack_v2 joins buffers directly). Large sections
        # split into chunks purely so the container crc32s parallelize
        # (the decoder joins the chunks back — same bytes; small
        # containers keep the single chunk, so committed fixtures are
        # unchanged). The crcs are submitted here so they overlap the
        # OTHER sections' coding instead of serializing inside pack_v2.
        import zlib

        t_view = memoryview(tight)
        out = entropy.ChunkList(
            [t_view]
            if len(t_view) <= _VERBATIM_CHUNK
            else [
                t_view[i : i + _VERBATIM_CHUNK]
                for i in range(0, len(t_view), _VERBATIM_CHUNK)
            ]
        )
        from .core.entropy import _pool

        out.crcs = [_pool().submit(zlib.crc32, c) for c in out]
        return out

    def _exc_task():
        exc_tight = entropy.take_row_prefixes(exc_rows, exc_counts)
        if header.zst:
            return entropy.chunked_zstd(
                memoryview(exc_tight), cfg.chunk_bytes, 1
            )
        if header.rans:
            return [native.rans_compress(exc_tight)]
        # level 3: measured smaller AND faster than 6 on this stream
        return entropy.chunked_deflate(
            memoryview(exc_tight), cfg.chunk_bytes, min(lvl, 3)
        )

    # width/meta: mostly-noisy small ints. zstd-1 is both smaller and
    # faster than any deflate level here (width: 4.6 KB / 0.2 ms vs
    # deflate-1's 8.4 KB / 0.5 ms per 131 KB). zlib fallback: deflate
    # level buys almost nothing (bench meta: 4 KB at level 6 vs 5 KB at
    # level 1 from 262 KB) but level 6 costs ~15 ms per 256 KB of counts;
    # large streams take level 1, small ones keep lvl (fixtures stay
    # byte-stable)
    def _side_sec(data) -> list[bytes]:
        if header.zst:
            return entropy.chunked_zstd(data, cfg.chunk_bytes, 1)
        sl = min(lvl, 1) if len(data) >= (1 << 17) else lvl
        return entropy.chunked_deflate(data, cfg.chunk_bytes, sl)

    def _meta_task():
        meta = (
            struct.pack(_DPK_META_FMT, n_stream, tile_b, cw)
            + exc_counts.astype(np.uint16).tobytes()
            + np.asarray(ac_counts, np.uint16).tobytes()
        )
        return _side_sec(meta)

    pool = entropy.section_pool()
    f_packed = pool.submit(_packed_task)
    f_exc = pool.submit(_exc_task)
    f_meta = pool.submit(_meta_task)
    width_sec = _side_sec(width.tobytes())
    return (width_sec, f_packed.result(), f_exc.result(), f_meta.result())


def _dpk_host_rebuild(
    header: ct.Header, streams, tile_range=None, float_planes=False,
    meta=None,
):
    """Re-inflate a DPK container's small side streams and re-pad the tight
    layouts into the fixed-capacity device inputs. Returns
    (width (T,bs), rows, exc_rows, dc_raw, ac_raw, n_stream, tile_b, cw,
    ac_counts, nblk).

    tile_range=(t0, t1): rebuild only tiles [t0, t1) — the multi-host slice
    decode (parallel/multihost.decompress_multihost). width/rows/exc_rows
    cover just the slice (the BULK packed section is byte-range-sliced:
    zero-copy for verbatim containers, chunk-range-decoded for the
    dpks/dpkz ratio modes), while meta/dc_raw/ac_raw/ac_counts/nblk stay
    GLOBAL — the caller slices DC/AC by its own count prefixes."""
    from . import native
    from .ops import idpack

    widths_z, packed_raw, exc_z, meta_z, dz, az = streams
    # the six sections decode independently — run them concurrently on the
    # section pool (zlib/rANS release the GIL) and join at the row re-pads
    pool = entropy.section_pool()

    _side = entropy.chunked_unzstd if header.zst else entropy.chunked_inflate

    def _tight_task():
        if header.dpks:
            return entropy.chunked_unzstd(packed_raw)
        if header.dpkz:
            return entropy.chunked_inflate(packed_raw)
        if header.dpkr:
            entropy.verify_chunk_range(packed_raw)
            return native.rans_decompress(entropy.join_chunks(packed_raw))
        entropy.verify_chunk_range(packed_raw)
        return entropy.join_chunks(packed_raw)  # zero-copy for verbatim views

    def _tight_range(b0: int, b1: int):
        """Decoded bytes [b0, b1) of the packed section, touching as little
        of it as possible: verbatim sections slice the container buffer
        itself; chunked host codecs decode only the covering chunks; the
        joined rANS stream has no random access (full decode + slice)."""
        if header.dpks:
            return entropy.decode_chunk_range(
                packed_raw, b0, b1, entropy.zstd_decompress
            )
        if header.dpkz:
            import zlib

            return entropy.decode_chunk_range(
                packed_raw, b0, b1, lambda c: zlib.decompress(bytes(c))
            )
        if header.dpkr:
            entropy.verify_chunk_range(packed_raw)  # no random access
            return memoryview(
                native.rans_decompress(entropy.join_chunks(packed_raw))
            )[b0:b1]
        # verbatim: decoded offset == stored offset, crc only the covering
        # chunks (deferred-crc parses; plain parses already swept)
        entropy.verify_covering_chunks(packed_raw, b0, b1)
        return memoryview(entropy.join_chunks(packed_raw))[b0:b1]

    def _exc_task():  # zst/rans flags cover the exceptions in DPK containers
        if header.zst:
            return entropy.chunked_unzstd(exc_z)
        if header.rans:
            entropy.verify_chunk_range(exc_z)
            return native.rans_decompress(b"".join(exc_z))
        return entropy.chunked_inflate(exc_z)

    def _exc_range(e0: int, e1: int):
        """Exception bytes [e0, e1) (byte offsets == item offsets: 1 byte
        each) — the tile-range path decodes and crc-verifies only the
        covering chunks; the joined rANS stream has no random access."""
        if header.zst:
            return entropy.decode_chunk_range(
                exc_z, e0, e1, entropy.zstd_decompress
            )
        if header.rans:
            entropy.verify_chunk_range(exc_z)
            return memoryview(
                native.rans_decompress(b"".join(exc_z))
            )[e0:e1]
        return entropy.decode_chunk_range(exc_z, e0, e1, entropy.inflate)

    f_width = pool.submit(_side, widths_z)
    if tile_range is None:
        f_tight = pool.submit(_tight_task)
        f_exc = pool.submit(_exc_task)
    if float_planes == "skip":
        # the caller range-decodes DC/AC itself (_float_section_range) —
        # hand back the raw section chunk lists untouched
        f_dc = f_ac = None
    else:
        f_dc = pool.submit(_float_raw, header, dz, bool(float_planes))
        f_ac = pool.submit(_float_raw, header, az, bool(float_planes))

    if meta is None:
        meta = _side(meta_z)
    n_stream, tile_b, cw = struct.unpack_from(_DPK_META_FMT, meta, 0)
    bs = header.block_size
    nblk = -(-n_stream // bs)  # n_stream = true length on the XLA path
    t = idpack.tiles_of(nblk, tile_b)
    rows_n = bs * t
    off = _DPK_META_SIZE
    n_chunks = (nblk * bs) // cw
    exc_counts = np.frombuffer(meta, np.uint16, n_chunks, off).astype(
        np.int64
    )
    ac_counts = np.frombuffer(
        meta, np.uint16, n_chunks, off + 2 * n_chunks
    ).astype(np.int64)

    width = np.frombuffer(f_width.result(), np.uint8, rows_n).reshape(t, bs)
    bpr = idpack.packed_nbytes(width.reshape(-1), tile_b)
    if tile_range is not None:
        t0, t1 = tile_range
        epc = (tile_b * bs) // cw  # chunk rows per tile
        cum = np.concatenate(([0], np.cumsum(bpr, dtype=np.int64)))
        tight = _tight_range(int(cum[t0 * bs]), int(cum[t1 * bs]))
        width = width[t0:t1]
        bpr = bpr[t0 * bs : t1 * bs]
        c0 = t0 * epc
        c1 = min(t1 * epc, n_chunks)
        ecum = np.concatenate(([0], np.cumsum(exc_counts, dtype=np.int64)))
        exc_counts_loc = exc_counts[c0:c1]
        f_exc_r = pool.submit(_exc_range, int(ecum[c0]), int(ecum[c1]))
        f_rows = pool.submit(
            lambda: entropy.pad_row_prefixes(
                tight, bpr, tile_b // 2, np.uint8
            )
        )
        exc_tight = np.frombuffer(f_exc_r.result(), np.uint8)
    else:
        exc_counts_loc = exc_counts
        # the two row re-pads are independent of each other and of the DC/AC
        # sections: run the packed one on the pool while this thread pads the
        # exceptions (the pads are the decode-host cost center after the
        # section inflations)
        f_rows = pool.submit(
            lambda: entropy.pad_row_prefixes(
                f_tight.result(), bpr, tile_b // 2, np.uint8
            )
        )
        exc_tight = np.frombuffer(f_exc.result(), np.uint8)
    peak_e = int(exc_counts_loc.max()) if exc_counts_loc.size else 0
    cape = next(
        c
        for c in [c for c in (32, 64, 128, 256) if c < cw] + [cw]
        if c >= min(peak_e, cw)
    )
    exc_rows = entropy.pad_row_prefixes(
        exc_tight, exc_counts_loc, cape, np.uint8
    )

    rows = f_rows.result()
    dc_raw = dz if f_dc is None else f_dc.result()
    ac_raw = az if f_ac is None else f_ac.result()
    return (
        width, rows, exc_rows, dc_raw, ac_raw, n_stream, tile_b, cw,
        ac_counts, nblk,
    )


def _capc_tier(peak: int, cw: int) -> int:
    """Smallest AC row-capacity tier covering the per-chunk peak (shared
    by the monolithic, sharded, and slice-range decode preps — they must
    agree or row shapes desynchronize)."""
    tiers = [tt for tt in (32, 64, 128) if tt < cw] + [cw]
    return next(tt for tt in tiers if tt >= min(peak, cw))


def _stored_dtype(header: ct.Header, dc_nbytes: int, nblk: int, cfg):
    """(stored dtype, cfg) from the DC section length: an f64 container
    whose DC section holds 8-byte items was written with truncate=False
    (full-width floats end-to-end)."""
    stored = np.dtype(np.float32)
    if dc_nbytes == nblk * header.dtype.itemsize and header.dtype != stored:
        return header.dtype, dataclasses.replace(cfg, truncate=False)
    return stored, cfg


def _dpk_decode_prep(header: ct.Header, streams):
    """Host stage of DPK decompress: re-inflate the small side streams and
    re-pad the tight layouts into fixed-capacity device arrays.

    Returns ((width, packed_rows, exc_rows, dc, ac) numpy arrays,
    (n_stream, tile_b, cw, cfg)). Split out of _decompress_dpk so
    the stream reader can run it on its host worker."""
    (
        width, rows, exc_rows, dc_raw, ac_raw, n_stream, tile_b, cw,
        ac_counts, nblk,
    ) = _dpk_host_rebuild(header, streams, float_planes=True)

    cfg = _header_config(header)
    stored = np.dtype(np.float32)
    dc_pl = isinstance(dc_raw, tuple)
    ac_pl = isinstance(ac_raw, tuple)
    if not dc_pl:
        stored, cfg = _stored_dtype(header, len(dc_raw), nblk, cfg)
    if dc_pl:
        # (4, nblk) u8 byte planes — no host unshuffle; the device decode
        # programs reassemble (api._combine_planes)
        dc = np.stack(
            [np.frombuffer(p, np.uint8, nblk) for p in dc_raw[1]]
        )
    else:
        dc = np.frombuffer(dc_raw, dtype=stored, count=nblk)

    # per-chunk AC rows from the stored per-chunk counts (no id-stream
    # rescan); the device places them with a one-hot contraction (see
    # backend.py for why decode avoids the global-stream gather)
    peak = int(ac_counts.max()) if ac_counts.size else 0
    capc = _capc_tier(peak, cw)
    if ac_pl:
        pls = [
            np.frombuffer(p, np.uint8, header.ac_count) for p in ac_raw[1]
        ]
        tight = np.concatenate(pls) if len(pls) > 1 else pls[0]
        # one tiled pad call re-pads all planes (see _pack_dpk_v2)
        ac = entropy.pad_row_prefixes(
            tight, np.tile(ac_counts, len(pls)), capc, np.uint8
        ).reshape(len(pls), ac_counts.size, capc)
    else:
        ac = np.frombuffer(ac_raw, dtype=stored, count=header.ac_count)
        ac = entropy.pad_row_prefixes(ac, ac_counts, capc, stored)
    return (width, rows, exc_rows, dc, ac), (n_stream, tile_b, cw, cfg)


def _decompress_dpk(header: ct.Header, streams, qtable, timer) -> np.ndarray:
    """Decompress a DPK container: the host only re-inflates the small side
    streams and re-pads the tight layouts into fixed-capacity rows; the id
    stream itself is decoded on device (_decode_device_dpk)."""
    with timer.stage("host"):
        host_arrays, (n_stream, tile_b, cw, cfg) = (
            _dpk_decode_prep(header, streams)
        )
        width, rows, exc_rows, dc, ac = host_arrays
        n = header.num_elements

    out_dtype = header.dtype
    work = _decode_work_dtype(header)
    with timer.stage("transfer"):
        dev = (
            jnp.asarray(width),
            jnp.asarray(rows),
            jnp.asarray(exc_rows),
            jnp.asarray(dc),
            jnp.asarray(ac),
        )
        sf = jnp.asarray(header.scaling_factor, jnp.dtype(work))
        qt = (
            jnp.asarray(qtable).astype(jnp.dtype(work))
            if qtable is not None
            else None
        )
        if timer.sync:
            # attribute async h2d time here, not to the device stage
            jax.block_until_ready(dev)
    with timer.stage("device"):
        x = _decode_device_dpk(
            *dev,
            n_stream,
            _device_cfg(cfg),
            work,
            tile_b,
            cw,
            sf,
            qt,
            header.dcd,
        )
        if timer.sync:
            jax.block_until_ready(x)
    with timer.stage("transfer"):
        out = np.asarray(jax.device_get(x), dtype=out_dtype)
    return out[:n]


def _decompress_dpk_sharded(header: ct.Header, streams, qtable, mesh) -> np.ndarray:
    """Sharded decompress of a DPK container: re-pad the tile-/chunk-major
    host layouts to a whole-tile multiple of the mesh size (synthetic zero
    tiles decode to zero blocks) and run the shard-local decode program
    (parallel/sharding.decode_sharded_dpk) over the mesh."""
    from .parallel import sharding as sh

    (
        width, rows, exc_rows, dc_raw, ac_raw, n_stream, tile_b, cw,
        ac_counts, nblk,
    ) = _dpk_host_rebuild(header, streams)
    n = header.num_elements
    cfg = _header_config(header)
    bs = header.block_size
    n_dev = mesh.devices.size
    if n_stream % bs:
        # rem-point tail basis (XLA-encoded container with a partial tail
        # block): the sharded body transforms whole blocks only — decode
        # single-chip (device-encoded streams are always block-padded)
        from .utils.timing import StageTimer

        return _decompress_dpk(header, streams, qtable, StageTimer())

    stored, cfg = _stored_dtype(header, len(dc_raw), nblk, cfg)
    dc = np.frombuffer(dc_raw, dtype=stored, count=nblk)
    if header.dcd:  # the sharded decode body takes DC values, not deltas
        dc = entropy.f32_delta_inv(dc)
    ac = np.frombuffer(ac_raw, dtype=stored, count=header.ac_count)

    # chunked AC rows straight from the stored per-chunk counts (no id
    # rescan); chunked layout regardless of backend — counts are free here
    peak = int(ac_counts.max()) if ac_counts.size else 0
    capc = _capc_tier(peak, cw)
    ac_rows = entropy.pad_row_prefixes(ac, ac_counts, capc, stored)

    # pad every array to tpd whole tiles (leading axes shard evenly)
    t = width.shape[0]
    tpd = -(-t // n_dev) * n_dev
    epc = tile_b * bs // cw  # chunk rows per tile

    def _pad_rows(a: np.ndarray, want: int) -> np.ndarray:
        if a.shape[0] == want:
            return a
        pad = np.zeros((want - a.shape[0],) + a.shape[1:], a.dtype)
        return np.concatenate([a, pad])

    width = _pad_rows(width, tpd)
    rows = _pad_rows(rows, tpd * bs)
    exc_rows = _pad_rows(exc_rows, tpd * epc)
    ac_rows = _pad_rows(ac_rows, tpd * epc)
    dc = _pad_rows(dc, tpd * tile_b)

    out_dtype = header.dtype
    work = _decode_work_dtype(header)
    spec = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(sh.AXIS))
    qt = (
        jnp.asarray(qtable).astype(jnp.dtype(work))
        if qtable is not None
        else None
    )
    x = sh.decode_sharded_dpk(
        jax.device_put(width, spec),
        jax.device_put(rows, spec),
        jax.device_put(exc_rows, spec),
        jax.device_put(dc, spec),
        jax.device_put(ac_rows, spec),
        jnp.asarray(header.scaling_factor, jnp.dtype(work)),
        qt,
        tile_b=tile_b,
        cw=cw,
        cfg=_device_cfg(cfg),
        dtype=work,
        mesh=mesh,
    )
    return np.asarray(jax.device_get(x), dtype=out_dtype)[:n]


def _dpk_meta(header: ct.Header, streams, *, with_bytes: bool = False):
    """(n_stream, tile_b, cw) from a DPK container's meta section alone —
    the multi-host decoder needs the tile geometry to pick its slice BEFORE
    committing to any bulk-section work. with_bytes=True appends the
    decoded meta buffer so the caller can hand it to _dpk_host_rebuild
    (which otherwise re-inflates the same section)."""
    _side = entropy.chunked_unzstd if header.zst else entropy.chunked_inflate
    meta = _side(streams[3])
    triple = struct.unpack_from(_DPK_META_FMT, meta, 0)
    return triple + (meta,) if with_bytes else triple


def _decompress_dpk_range(
    header: ct.Header, streams, qtable, t0: int, t1: int, meta=None
) -> np.ndarray:
    """Decode ONLY tiles [t0, t1) of a monolithic DPK container — the
    multi-host parallel decode of one big container (each host takes a
    tile-aligned range; the reference decompresses strictly single-shot,
    dctz-decomp-lib.c). The bulk packed section is byte-range-sliced on the
    host (zero-copy for verbatim containers); the device decodes only the
    slice's tiles. DC/AC float sections still decode fully per host (their
    PLC planes span the array) — a known follow-up.

    Returns the decoded elements of [t0*tile_b*bs, min(t1*tile_b*bs,
    num_elements)) in the container dtype."""
    (
        width, rows, exc_rows, dc_chunks, ac_chunks_raw, n_stream, tile_b,
        cw, ac_counts, nblk,
    ) = _dpk_host_rebuild(
        header, streams, tile_range=(t0, t1), float_planes="skip",
        meta=meta,
    )
    cfg = _header_config(header)
    bs = header.block_size
    n_chunks = (nblk * bs) // cw
    epc = (tile_b * bs) // cw

    # DC/AC decode only this slice's items (plane chunk ranges; legacy
    # non-PLC sections fall back to full-decode-and-slice)
    b0, b1 = t0 * tile_b, min(t1 * tile_b, nblk)
    c0, c1 = t0 * epc, min(t1 * epc, n_chunks)
    acum = np.concatenate(([0], np.cumsum(ac_counts, dtype=np.int64)))
    a0, a1 = int(acum[c0]), int(acum[c1])
    dc_kind, dc_dat = _float_section_range(header, dc_chunks, b0, b1)
    ac_kind, ac_dat = _float_section_range(header, ac_chunks_raw, a0, a1)

    stored = np.dtype(np.float32)
    if dc_kind == "bytes":
        stored, cfg = _stored_dtype(header, len(dc_dat), nblk, cfg)

    counts_loc = ac_counts[c0:c1]
    peak = int(counts_loc.max()) if counts_loc.size else 0
    capc = _capc_tier(peak, cw)
    if ac_kind == "planes":
        pls = [np.frombuffer(p, np.uint8, a1 - a0) for p in ac_dat]
        tight = np.concatenate(pls) if len(pls) > 1 else pls[0]
        ac_rows = entropy.pad_row_prefixes(
            tight, np.tile(counts_loc, len(pls)), capc, np.uint8
        ).reshape(len(pls), counts_loc.size, capc)
    else:
        ac_loc = np.frombuffer(ac_dat, dtype=stored, count=header.ac_count)[
            a0:a1
        ]
        ac_rows = entropy.pad_row_prefixes(ac_loc, counts_loc, capc, stored)
    if dc_kind == "planes":
        dc_loc = np.stack(
            [np.frombuffer(p, np.uint8, b1 - b0) for p in dc_dat]
        )
    else:
        dc_loc = np.frombuffer(dc_dat, dtype=stored, count=nblk)[b0:b1]

    n_lo = t0 * tile_b * bs
    n_loc = min(t1 * tile_b * bs, n_stream) - n_lo

    out_dtype = header.dtype
    work = _decode_work_dtype(header)
    dev = (
        jnp.asarray(width),
        jnp.asarray(rows),
        jnp.asarray(exc_rows),
        jnp.asarray(dc_loc),
        jnp.asarray(ac_rows),
    )
    sf = jnp.asarray(header.scaling_factor, jnp.dtype(work))
    qt = (
        jnp.asarray(qtable).astype(jnp.dtype(work))
        if qtable is not None
        else None
    )
    x = _decode_device_dpk(
        *dev, n_loc, _device_cfg(cfg), work, tile_b, cw,
        sf, qt, header.dcd,
    )
    out = np.asarray(jax.device_get(x), dtype=out_dtype)
    n_hi = min(t1 * tile_b * bs, header.num_elements)
    return out[: n_hi - n_lo]


def _inflate_v2_streams(header: ct.Header, streams) -> tuple[bytes, bytes, bytes]:
    """Inflate + de-filter a v2 container's sections -> (bindex, dc, ac)."""
    if header.ids4:
        packed_z, exc_z, dz, az = streams
        if header.rans:
            from . import native

            packed = native.rans_decompress(b"".join(packed_z))
        else:
            packed = entropy.chunked_inflate(packed_z)
        exc = (
            entropy.chunked_unzstd(exc_z)
            if header.zst
            else entropy.chunked_inflate(exc_z)
        )
        # the original stream length is self-describing: exceptions hold one
        # byte per 15-nibble plus the odd tail byte (if any)
        p = np.frombuffer(packed, np.uint8)
        count15 = int(((p & 15) == 15).sum()) + int(((p >> 4) == 15).sum())
        odd = len(exc) - count15
        bindex = entropy.unpack_ids4(packed, exc, 2 * len(packed) + odd)
    else:
        (bz, dz, az) = streams
        bindex = entropy.chunked_inflate(bz)
    dc_raw = _decode_float_section(header, dz, dc=True)
    ac_raw = _decode_float_section(header, az)
    return bindex, dc_raw, ac_raw


def _chunk_escape_counts(flat_ids: np.ndarray, cw: int, bs: int) -> np.ndarray:
    """Per-chunk AC counts from the bin_index stream, single pass.

    Every block carries exactly one DC escape mark (dctz-comp-lib.c:361), so
    counts = (#ESCAPE bytes per chunk) - cw/bs. Parallelized over the
    entropy thread pool (numpy releases the GIL in the comparison/sum
    ufuncs); measured ~4x over the naive masked two-pass version.
    """
    from .core.entropy import _pool

    nc = flat_ids.size // cw
    view = flat_ids.reshape(nc, cw)
    nthreads = min(4, max(1, nc // 64))
    bounds = np.linspace(0, nc, nthreads + 1, dtype=int)
    out = np.empty(nc, np.int32)

    def work(i):
        lo, hi = bounds[i], bounds[i + 1]
        out[lo:hi] = (view[lo:hi] == C.ESCAPE).sum(axis=1, dtype=np.int32)

    list(_pool().map(work, range(nthreads)))
    return out - cw // bs


def _decode_work_dtype(header: ct.Header) -> str:
    """Device compute dtype for decode: the container dtype, except that
    float64 containers decode in float32 when x64 is disabled."""
    if header.dtype == np.float64 and not jax.config.jax_enable_x64:
        return "float32"
    return header.dtype.name


def _quantize_brsf(cfg: CodecConfig) -> CodecConfig:
    """Snap cfg.brsf to the container-representable grid (2**(k/8)) so the
    encoder uses EXACTLY the geometry the header records — without this a
    brsf != 1 container would silently decode with the wrong bin width."""
    import math

    if cfg.brsf == 1.0:
        return cfg
    code = min(255, max(1, round(math.log2(cfg.brsf) * 8.0) + 128))
    q = 2.0 ** ((code - 128) / 8.0)
    if q != cfg.brsf:
        warnings.warn(
            f"brsf {cfg.brsf} quantized to {q} (the container header grid)",
            stacklevel=3,
        )
        cfg = dataclasses.replace(cfg, brsf=q)
    return cfg


# auto-rate (cfg.rate="auto"): candidate bin-range scale factors, the
# container grid's powers of two. The size-vs-brsf curve is unimodal in
# practice (wider bins shrink the id stream until repair escapes dominate),
# so the ladder stops once size turns upward.
AUTO_RATE_LADDER = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)
_AUTO_SAMPLE_ELEMS = 1 << 22  # trial encodes run on <= 16 MB of samples


def _rate_sample(arr, n: int, block_size: int):
    """Block-aligned slices spread across the array (trial encodes must see
    representative statistics without paying full-array cost)."""
    if n <= _AUTO_SAMPLE_ELEMS:
        return arr
    k = 8
    seg = _AUTO_SAMPLE_ELEMS // k
    seg -= seg % block_size
    step = (n - seg) // (k - 1)
    step -= step % block_size
    parts = [arr[i * step : i * step + seg] for i in range(k)]
    xp = jnp if isinstance(arr, jax.Array) else np
    return xp.concatenate(parts)


def _auto_rate_brsf(arr, n: int, cfg: CodecConfig) -> float:
    """Pick the ladder brsf with the smallest compressed size on a sample.

    Every trial runs the REAL encoder (verify-repair on), so the chosen
    geometry's bound behavior is exactly what the final encode ships."""
    sample = _rate_sample(arr, n, cfg.block_size)
    best_b, best_sz = 1.0, None
    for b in AUTO_RATE_LADDER:
        trial_cfg = dataclasses.replace(
            cfg, brsf=b, rate="fixed", segment_elems=None, verify=True
        )
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            sz = len(compress(sample, config=trial_cfg))
        if any("pointwise bound" in str(w.message) for w in caught):
            # this geometry cannot hold the bound even with repair (f32
            # truncation floor) — never select it; wider only gets worse
            break
        if best_sz is None or sz < best_sz:
            best_b, best_sz = b, sz
        elif sz > best_sz * 1.02:
            break  # the curve turned upward; escapes now dominate
    return best_b


def _resolve_segment(cfg: CodecConfig, n: int) -> int | None:
    """Segment size for the pipelined DTZS path, or None for monolithic.

    "auto" (the default) engages DEFAULT_SEGMENT-element frames for v2
    arrays of >= stream.AUTO_THRESHOLD elements, so the host entropy stage
    overlaps device compute instead of serializing after it. v1 stays
    monolithic (the reference container has no framing). QT joins EC under
    "auto" as of round 5: the stream writer runs a global qtable pre-pass
    (pass 1 over every segment, max-reduced) so each frame renormalizes
    against the whole-array table — the streamed encoding decodes
    bit-identically to the monolithic encoding OF THE SAME DISPATCH
    (stream.compress_stream, tests/test_stream.py). For lengths that are
    not block multiples, device-coded (DPK) frames transform a zero-padded
    64-point tail block where the host-coded path uses the rem-point basis;
    both stay within the bound."""
    from . import stream as dstream

    se = cfg.segment_elems
    if se == "auto":
        if (
            cfg.container == "v2"
            and cfg.mode in ("ec", "qt")
            and n >= dstream.AUTO_THRESHOLD
        ):
            return dstream.DEFAULT_SEGMENT
        return None
    if se and n >= 2 * se:
        return se
    return None


def _resolve_input(x, cfg: CodecConfig) -> jax.Array:
    """Validate dtype / x64 availability; apply internal_dtype policy."""
    arr = jnp.asarray(x)
    if arr.ndim != 1:
        arr = arr.reshape(-1)  # reference treats data as flat 1-D
    if arr.dtype not in (jnp.float32, jnp.float64):
        raise TypeError(f"unsupported dtype {arr.dtype}; use float32/float64")
    src_f64 = (
        np.dtype(x.dtype if hasattr(x, "dtype") else np.float64) == np.float64
    )
    promote = src_f64 and cfg.internal_dtype == "float32"
    if promote and arr.dtype == jnp.float64:
        arr = arr.astype(jnp.float32)
    if src_f64 and arr.dtype == jnp.float32 and not promote:
        warnings.warn(
            "float64 input was downcast to float32 because jax x64 is "
            "disabled; enable jax_enable_x64 for full-precision parity",
            stacklevel=3,
        )
    return arr


def compress(
    x: Any,
    error_bound: float = 1e-3,
    mode: str = "ec",
    *,
    config: CodecConfig | None = None,
    timer=None,
) -> bytes:
    """Compress a flat float array; returns the container bytes.

    Equivalent to dctz_compress (dctz-comp-lib.c:90) with the mode selected
    at runtime instead of compile time. Pass a utils.timing.StageTimer as
    `timer` for the reference's TIME_DEBUG-style per-stage breakdown.
    """
    from .utils.timing import StageTimer

    timer = timer or StageTimer()
    cfg = config or CodecConfig(mode=mode, error_bound=error_bound)
    if cfg.rate == "auto":
        if cfg.container == "v1":
            warnings.warn(
                "rate='auto' needs the v2 container (brsf lives in its "
                "header); writing v2 instead",
                stacklevel=2,
            )
            cfg = dataclasses.replace(cfg, container="v2")
        if not cfg.verify:
            # the widened geometry relies on verify-repair for the bound
            cfg = dataclasses.replace(cfg, verify=True)
    if cfg.container == "v1" and (
        cfg.block_size != C.BLK_SZ or cfg.nbins != C.NBINS
    ):
        # The v1 format is the reference's fixed layout (dctz.h:96-119): it
        # carries no block_size/nbins fields, so parse_v1 MUST assume 64/255.
        # Anything else silently corrupts on decode — upgrade to v2, which
        # records the geometry.
        warnings.warn(
            "v1 containers only support block_size=64 / nbins=255 (the "
            "reference layout has no geometry fields); writing v2 instead",
            stacklevel=2,
        )
        cfg = dataclasses.replace(cfg, container="v2")
    if cfg.brsf != 1.0:
        if cfg.container == "v1":
            warnings.warn(
                "v1 containers cannot record brsf (fixed reference layout);"
                " writing v2 instead",
                stacklevel=2,
            )
            cfg = dataclasses.replace(cfg, container="v2")
        cfg = _quantize_brsf(cfg)
    src_dtype = np.dtype(getattr(x, "dtype", np.float64))
    arr = _resolve_input(x, cfg)
    n = int(arr.shape[0])
    if n == 0:
        raise ValueError("cannot compress an empty array")

    if cfg.rate == "auto":
        cfg = dataclasses.replace(
            cfg, brsf=_auto_rate_brsf(arr, n, cfg), rate="fixed"
        )

    seg = _resolve_segment(cfg, n)
    if seg:
        # pipelined path (the DEFAULT for large v2 EC arrays, cfg.segment_
        # elems="auto"): device encode of segment k+1 overlaps host packing
        # of segment k; emits a DTZS stream (decompress() auto-detects and
        # pipelines the inverse). Device-resident input stays on device —
        # stats reduce there and segments are HBM slices.
        import io

        from . import stream as dstream

        buf = io.BytesIO()
        with timer.stage("pipeline"):
            dstream.compress_stream(
                arr, buf, config=cfg, segment_elems=seg
            )
        return buf.getvalue()

    dpk = backend.device_ids(cfg)
    with timer.stage("device"):
        q, stats = _encode_device(arr, n, _device_cfg(cfg))
        if dpk:
            from .ops import idpack

            nblk_s, bs_s = q.bin_ids.shape
            cw = qz.chunk_width(nblk_s * bs_s, bs_s)
            pk = _dpk_pack_device(q.bin_ids, n)
            ac_counts_dev = idpack.ac_chunk_counts(q.bin_ids, n, cw)
    if q.bound_ok is not None and not bool(jax.device_get(q.bound_ok)):
        warnings.warn(
            "verify-repair could not fully satisfy the pointwise bound "
            "(float32-truncation floor); see docs/numerics.md",
            stacklevel=2,
        )
    with timer.stage("transfer"):
        if dpk:
            ac_buf, cnt = jax.device_get((q.ac_buf, q.ac_count))
            ac, ac_count = ac_buf[: int(cnt)], int(cnt)
            width, packed_rows, exc_rows, exc_counts = jax.device_get(pk)
            ac_counts = np.asarray(jax.device_get(ac_counts_dev))
        else:
            ac, bin_ids, ac_count = _assemble_ac(q)
        dc, sf, mean = jax.device_get((q.dc, stats.sf, stats.mean))
        qtable = jax.device_get(q.qtable) if q.qtable is not None else None

    # The header always records the ORIGINAL dtype: with internal_dtype=
    # "float32" the streams are float32 either way (USE_TRUNCATE semantics),
    # so a float64 file stays declared float64 and decodes at full width.
    header = ct.Header(
        dtype=src_dtype,
        num_elements=n,
        error_bound=cfg.error_bound,
        ac_count=ac_count,
        scaling_factor=float(sf),
        mean=float(mean),
        bindex_nbytes=0,
        dc_nbytes=0,
        ac_nbytes=0,
        mode=cfg.mode,
        block_size=cfg.block_size,
        nbins=cfg.nbins,
        truncate=cfg.truncate,
        brsf=cfg.brsf,
    )
    if dpk:
        from .ops import idpack

        header.shuffle = cfg.shuffle
        with timer.stage("zlib"):
            # n_stream = TRUE length: the encoder gave the tail block a
            # rem-point basis, and decode mirrors block structure from
            # n_stream (stream DPK frames store the padded length instead —
            # they transform whole zero-padded blocks).
            streams = _dpk_sections(
                width,
                packed_rows,
                exc_rows,
                exc_counts,
                ac_counts,
                idpack.B_DEFAULT,
                cw,
                n,
                cfg,
                header,
            ) + (
                _float_sections(dc.tobytes(), dc.dtype.itemsize, cfg, header, dc=True),
                _float_sections(ac.tobytes(), ac.dtype.itemsize, cfg, header),
            )
            return ct.pack_v2(header, streams, qtable, cfg.chunk_bytes)
    flat_ids = bin_ids.reshape(-1)[:n]

    with timer.stage("zlib"):
        if cfg.container == "v1":
            bz, dz, az = entropy.deflate_streams(
                [flat_ids.tobytes(), dc.tobytes(), ac.tobytes()],
                cfg.zlib_level,
            )
            header.bindex_nbytes = len(bz)
            header.dc_nbytes = len(dz)
            header.ac_nbytes = len(az)
            return ct.pack_v1(header, bz, dz, az, qtable)

        header.shuffle = cfg.shuffle
        streams = _ids_streams(flat_ids.tobytes(), cfg, header) + (
            _float_sections(dc.tobytes(), dc.dtype.itemsize, cfg, header, dc=True),
            _float_sections(ac.tobytes(), np.asarray(ac).dtype.itemsize, cfg, header),
        )
        return ct.pack_v2(header, streams, qtable, cfg.chunk_bytes)


def _header_config(header: ct.Header) -> CodecConfig:
    return CodecConfig(
        mode=header.mode,
        error_bound=header.error_bound,
        truncate=header.truncate,
        block_size=header.block_size,
        nbins=header.nbins,
        brsf=header.brsf,
    )


def decompress(blob: bytes | memoryview, *, timer=None) -> np.ndarray:
    """Decompress a container (either format) back to a flat numpy array.

    Equivalent to dctz_decompress (dctz-decomp-lib.c:51). Pass a
    utils.timing.StageTimer as `timer` for the reference's TIME_DEBUG-style
    per-stage breakdown (host / device / transfer)."""
    from .utils.timing import StageTimer

    timer = timer or StageTimer()
    if bytes(memoryview(blob)[:4]) == b"DTZS":
        # segmented stream container (stream.py) — zero-copy frame reads;
        # the output buffer is allocated once (peak extra memory ~ one
        # segment). For > RAM arrays use stream.decompress_stream directly.
        from . import stream as _stream

        with timer.stage("pipeline"):
            return _stream.decompress_stream_all(_stream.MemReader(blob))
    is_v2 = ct.detect_format(blob) == "v2"
    if is_v2:
        with timer.stage("host"):  # chunk split + crc verify = host work
            header, streams, qtable, _cb = ct.parse_v2(blob)
        if header.dpk:
            return _decompress_dpk(header, streams, qtable, timer)
        with timer.stage("host"):
            bindex, dc_raw, ac_raw = _inflate_v2_streams(header, streams)
    else:
        header, bz, dz, az, qtable = ct.parse_v1(blob)
        with timer.stage("host"):
            bindex, dc_raw, ac_raw = entropy.inflate_streams([bz, dz, az])

    with timer.stage("host"):
        n = header.num_elements
        cfg = _header_config(header)
        bs = header.block_size
        # Sharded v2 containers are zero-padded to the mesh quantum; the
        # padded length is simply the bin_index stream length (v1: exactly n).
        n_stream = len(bindex)
        nblk = -(-n_stream // bs)

        # The reference always ships truncated (float32) DC/AC streams;
        # detect non-truncated files by the DC stream size.
        stored, cfg = _stored_dtype(header, len(dc_raw), nblk, cfg)

        flat_ids = np.frombuffer(bindex, dtype=np.uint8, count=n_stream)
        pad = nblk * bs - n_stream
        if pad:
            # zero-pad (bin 0 = center), then give padded blocks their DC
            # mark so the per-block-escape invariant holds for the count pass
            # below (idempotent for real blocks: dctz-comp-lib.c:361 always
            # marks DC).
            flat_ids = np.concatenate([flat_ids, np.zeros(pad, np.uint8)])
            flat_ids.reshape(nblk, bs)[:, 0] = C.ESCAPE
        dc = np.frombuffer(dc_raw, dtype=stored, count=nblk)
        ac = np.frombuffer(ac_raw, dtype=stored, count=header.ac_count)

        # per-chunk AC rows, counts derived from bin_index (see backend.py
        # for why decode avoids the global-stream gather)
        cw = qz.chunk_width(nblk * bs, bs)
        counts = _chunk_escape_counts(flat_ids, cw, bs)
        ac = entropy.pad_row_prefixes(
            ac, counts, _capc_tier(int(counts.max()) if counts.size else 0, cw),
            stored,
        )

    out_dtype = header.dtype
    work_dtype = _decode_work_dtype(header)

    with timer.stage("transfer"):
        ids_d = jnp.asarray(flat_ids.reshape(nblk, bs))
        dc_d = jnp.asarray(dc)
        ac_d = jnp.asarray(ac)
        sf = jnp.asarray(header.scaling_factor, jnp.dtype(work_dtype))
        qt = (
            jnp.asarray(qtable).astype(jnp.dtype(work_dtype))
            if qtable is not None
            else None
        )
        if timer.sync:
            # attribute async h2d time here, not to the device stage
            jax.block_until_ready((ids_d, dc_d, ac_d))
    with timer.stage("device"):
        x = _decode_device(
            ids_d,
            dc_d,
            ac_d,
            n_stream,
            _device_cfg(cfg),
            work_dtype,
            False,
            sf,
            qt,
        )
        if timer.sync:
            jax.block_until_ready(x)
    with timer.stage("transfer"):
        out = np.asarray(jax.device_get(x), dtype=out_dtype)
    return out[:n]


# ---------------------------------------------------------------------------
# Sharded (multi-chip) paths
# ---------------------------------------------------------------------------


def compress_sharded(
    x: Any,
    error_bound: float = 1e-3,
    mode: str = "ec",
    *,
    config: CodecConfig | None = None,
    mesh=None,
) -> bytes:
    """Compress an array sharded over a device mesh; emits a v2 container.

    Per-shard work is fully local (blocks never cross shards); only the
    scaling factor / mean / QT-qtable reductions cross devices. The output is
    byte-compatible with the single-chip v2 path up to zero-padding of the
    streams (decompress() handles both transparently).
    """
    from .parallel import sharding as sh

    cfg = config or CodecConfig(mode=mode, error_bound=error_bound, container="v2")
    if cfg.container != "v2":
        cfg = dataclasses.replace(cfg, container="v2")
    cfg = _quantize_brsf(cfg)
    src_dtype = np.dtype(getattr(x, "dtype", np.float64))

    from .ops import idpack

    dpk = backend.device_ids(cfg)
    mesh = mesh or sh.make_mesh()
    quantum = idpack.B_DEFAULT if dpk else 1
    promote = src_dtype == np.float64 and (
        cfg.internal_dtype == "float32" or not jax.config.jax_enable_x64
    )
    if isinstance(x, jax.Array) and not isinstance(x, np.ndarray):
        # device-resident input: flatten/promote/pad/reshard ON DEVICE —
        # the array never visits the host (VERDICT round-3 #4)
        n = int(np.prod(x.shape))
        if n == 0:
            raise ValueError("cannot compress an empty array")
        arr = x  # dtype bookkeeping only below
        x_sharded, n_pad = sh.shard_input_device(
            x, mesh, cfg.block_size, quantum, promote_f32=promote
        )
    else:
        arr = np.asarray(x).reshape(-1)
        if arr.dtype == np.float64 and promote:
            arr = arr.astype(np.float32)
        n = int(arr.shape[0])
        if n == 0:
            raise ValueError("cannot compress an empty array")
        x_sharded, n_pad = sh.shard_input(arr, mesh, cfg.block_size, quantum)
    arr = x_sharded  # downstream uses dtype only
    n_dev = mesh.devices.size

    def run(cape=None):
        return sh.encode_sharded(
            x_sharded,
            n_real=n,
            cfg=_device_cfg(cfg),
            mesh=mesh,
            dpk=dpk,
            cape=cape,
        )

    out = run()
    if dpk and int(jax.device_get(out[-1])) != 0:
        out = run(1 << 20)  # exception-capacity overflow: full chunk width
    base, extra = out[:8], out[8:]
    bin_ids, dc, ac_bufs, ac_counts, sf, mean, qtable, bound_ok = (
        jax.device_get(base)
    )
    if cfg.verify and not bool(bound_ok):
        warnings.warn(
            "verify-repair could not fully satisfy the pointwise bound "
            "(float32-truncation floor); see docs/numerics.md",
            stacklevel=2,
        )

    counts = [int(c) for c in ac_counts]
    ac = (
        np.concatenate([ac_bufs[d, : counts[d]] for d in range(n_dev)])
        if sum(counts)
        else np.zeros((0,), ac_bufs.dtype)
    )
    counts_total = sum(counts)

    header = ct.Header(
        dtype=src_dtype,
        num_elements=n,
        error_bound=cfg.error_bound,
        ac_count=counts_total,
        scaling_factor=float(sf),
        mean=float(mean),
        bindex_nbytes=0,
        dc_nbytes=0,
        ac_nbytes=0,
        mode=cfg.mode,
        block_size=cfg.block_size,
        nbins=cfg.nbins,
        truncate=cfg.truncate,
        brsf=cfg.brsf,
    )
    header.shuffle = cfg.shuffle
    dc_ac_z = (
        _float_sections(dc.tobytes(), dc.dtype.itemsize, cfg, header, dc=True),
        _float_sections(
            np.asarray(ac).tobytes(), np.asarray(ac).dtype.itemsize, cfg, header
        ),
    )
    if dpk:
        # per-shard tile-/chunk-major outputs ARE the global layout
        width, packed_rows, exc_rows, exc_counts, dpk_ac_counts, _ = (
            jax.device_get(extra)
        )
        streams = _dpk_sections(
            width,
            packed_rows,
            exc_rows,
            exc_counts,
            dpk_ac_counts,
            idpack.B_DEFAULT,
            qz.chunk_width(n_pad // n_dev, cfg.block_size),
            n_pad,
            cfg,
            header,
        ) + dc_ac_z
        return ct.pack_v2(
            header,
            streams,
            qtable if cfg.mode == "qt" else None,
            cfg.chunk_bytes,
        )
    streams = _ids_streams(bin_ids.reshape(-1).tobytes(), cfg, header) + dc_ac_z
    return ct.pack_v2(
        header, streams, qtable if cfg.mode == "qt" else None, cfg.chunk_bytes
    )


def decompress_sharded(blob: bytes | memoryview, *, mesh=None) -> np.ndarray:
    """Decompress with the device stage sharded over a mesh.

    The host inflates the streams, re-pads the AC stream into per-chunk rows
    (counts recomputed from bin_index alone), and runs the local
    dequantize+IDCT pipeline on every shard. DTZS streams (the DEFAULT
    compress() output for large arrays) restore frame by frame, each
    frame's device stage sharded, into one preallocated output."""
    from .parallel import sharding as sh
    from .utils.timing import StageTimer

    if bytes(memoryview(blob)[:4]) == b"DTZS":
        from . import stream as _stream

        reader = _stream.MemReader(blob)
        total = _stream._read_stream_header(reader)
        out: np.ndarray | None = None
        off = 0
        while True:
            raw = reader.read(_stream._FRAME.size)
            if len(raw) != _stream._FRAME.size:
                raise ValueError("truncated stream: missing frame header")
            (length,) = _stream._FRAME.unpack(raw)
            if not length:
                break
            body = reader.read(length)
            if len(body) != length:
                raise ValueError("truncated stream: frame body cut short")
            part = decompress_sharded(body, mesh=mesh)
            if out is None:
                if part.size == total:
                    return part
                out = np.empty(total, part.dtype)
            out[off : off + part.size] = part
            off += part.size
        if out is None or off != total:
            raise ValueError(
                f"truncated stream: {off} of {total} elements restored"
            )
        return out

    header, streams, qtable, _cb = ct.parse_v2(blob)
    if header.dpk:
        mesh = mesh or sh.make_mesh()
        return _decompress_dpk_sharded(header, streams, qtable, mesh)
    bindex, dc_raw, ac_raw = _inflate_v2_streams(header, streams)

    n = header.num_elements
    cfg = _header_config(header)
    bs = header.block_size
    mesh = mesh or sh.make_mesh()
    n_dev = mesh.devices.size

    ids = np.frombuffer(bindex, np.uint8)
    n_pad = sh.padded_size(len(ids), n_dev, bs)
    padded = n_pad != len(ids)
    if padded:
        # Pad with bin id 0 (center bin => coefficient 0): the padding
        # decodes to zero blocks, consumes no AC entries, and is sliced off.
        ids = np.concatenate([ids, np.zeros(n_pad - len(ids), np.uint8)])
    nblk = n_pad // bs
    ids2d = ids.reshape(nblk, bs)

    stored = np.dtype(np.float32) if header.truncate else header.dtype
    dc = np.zeros(nblk, stored)
    dc[: len(dc_raw) // stored.itemsize] = np.frombuffer(dc_raw, stored)
    ac = np.frombuffer(ac_raw, stored, count=header.ac_count)

    if padded:
        # give padded blocks a DC mark so the single-pass count helper's
        # per-block invariant holds (idempotent for real blocks; the array
        # is writable only after the padding concatenate)
        ids2d[:, 0] = C.ESCAPE
    # per-chunk AC rows, counts derived from bin_index; chunks never cross
    # shards (cw divides the shard length), so the rows shard with the ids
    cw = qz.chunk_width(n_pad // n_dev, bs)
    counts = _chunk_escape_counts(ids2d.reshape(-1), cw, bs)
    ac_rows = entropy.pad_row_prefixes(
        ac, counts, _capc_tier(int(counts.max()), cw), stored
    )

    out_dtype = header.dtype
    work = _decode_work_dtype(header)
    spec = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(sh.AXIS))
    x = sh.decode_sharded(
        jax.device_put(ids2d, spec),
        jax.device_put(dc, spec),
        jax.device_put(ac_rows, spec),
        jnp.asarray(header.scaling_factor, jnp.dtype(work)),
        jnp.asarray(
            qtable if qtable is not None else np.zeros(bs, work)
        ).astype(jnp.dtype(work)),
        n_pad=n_pad,
        cfg=_device_cfg(cfg),
        dtype=work,
        mesh=mesh,
    )
    return np.asarray(jax.device_get(x), dtype=out_dtype)[:n]
