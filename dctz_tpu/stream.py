"""Streamed / segmented compression for arrays larger than device memory.

SURVEY.md §5 (checkpoint/resume): the reference compresses single-shot,
in-memory arrays only; multi-TB checkpoint arrays need bounded-memory
streaming. A stream is a sequence of independent v2 containers behind a
small frame header:

    b"DTZS" | u16 version | u16 reserved | u64 total_elements
    repeat: u64 frame_len | v2 container bytes
    u64 0  (end marker)

Semantics match the monolithic codec exactly: a first pass computes the
GLOBAL max|x| (the scaling factor must see the whole array — reference
util.c:28), then each segment is encoded with that fixed sf. Because DCT
blocks never cross segment boundaries (segments are block-multiples), the
concatenated bin/DC/AC streams are element-for-element identical to the
monolithic encoding; only the zlib framing differs.

Each segment is also independently decodable => natural partial-restore and
parallel/distributed decompression.

Both directions run a two-stage software pipeline (VERDICT round-2 #4):
the writer's host worker entropy-codes segment k while the device encodes
segment k+1; the reader's host worker re-inflates frame k+1 while the
device decodes frame k. With the device id coder (ids_codec="device") each
segment runs one XLA program (DCT + quantize + verify-repair +
idpack.pack_ids_with_ac) and the DPK host packer (api._pack_dpk_v2), with
the verify tolerance and scaling factor computed globally first — so each
frame carries the same guarantee as a monolithic container. The monolithic
compress() routes here when cfg.segment_elems is set.
"""

from __future__ import annotations

import functools
import struct
import time
from typing import BinaryIO, Iterator

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
from .core.stats import scaling_factor

MAGIC = b"DTZS"
_HDR = struct.Struct("<4sHHQ")
_FRAME = struct.Struct("<Q")

DEFAULT_SEGMENT = 1 << 24  # 16Mi elements per segment
#: compress() auto-pipelines v2 EC arrays at or above this element count
#: (cfg.segment_elems="auto"): two DEFAULT_SEGMENT frames are the minimum
#: for the device/host stages to overlap at all.
AUTO_THRESHOLD = 2 * DEFAULT_SEGMENT


def _segment_coeffs(x: jax.Array, sf: jax.Array, cfg: CodecConfig):
    """Scaled-domain block DCT of one segment, (nblk, bs); a partial tail
    block gets the rem-point basis (transform.forward)."""
    from .api import _pad_coeffs

    xs = x / sf.astype(x.dtype)
    main_c, tail_c = transform.forward(
        xs, cfg.block_size, precision=backend.dct_precision(cfg.dct_precision)
    )
    return _pad_coeffs(main_c, tail_c, cfg.block_size)


@functools.partial(jax.jit, static_argnums=(3, 4))
def _encode_segment(
    x: jax.Array, sf: jax.Array, tol: jax.Array, n: int, cfg: CodecConfig,
    ext_qtable: jax.Array | None = None,
):
    """Segment encode with an externally fixed scaling factor.

    cfg.verify runs the verify-repair pass per segment against the
    GLOBALLY-computed tolerance `tol`. ext_qtable: the GLOBAL per-position escape maxima for QT
    segments (see _qtable_colmax_segment)."""
    coeffs = _segment_coeffs(x, sf, cfg)
    q = qz.encode(coeffs, n, cfg, ext_qtable=ext_qtable)
    if cfg.verify:
        from .ops import repair

        ids2, dense32, ok = repair.verify_repair(
            x, coeffs, sf, q.bin_ids, q.dc, q.qtable, n, n, cfg,
            tol.astype(x.dtype),
        )
        q = qz.repack(ids2, dense32, q.dc, q.qtable, n)
        q = q._replace(bound_ok=ok)
    return q


@functools.partial(jax.jit, static_argnums=(2, 3))
def _qtable_colmax_segment(x: jax.Array, sf: jax.Array, n: int, cfg):
    """QT pass 1 for one segment on the GENERIC path: per-position max
    |escaped coefficient| (unclamped; slot 0 zeroed). The stream writer
    max-reduces these to the global qtable — max is associative, so the
    result equals the monolithic whole-array pass (qz.encode's col_max,
    reference dctz-comp-lib.c:355-398)."""
    coeffs = _segment_coeffs(x, sf, cfg)
    nblk, bs = coeffs.shape
    w, rmin, rmax = qz._geometry(cfg, np.dtype(coeffs.dtype.name))
    _valid, ac_mask = qz._masks(nblk, bs, n)
    in_range = (coeffs >= rmin) & (coeffs <= rmax)
    escape = ac_mask & ~in_range
    col_max = jnp.max(
        jnp.where(escape, jnp.abs(coeffs), jnp.zeros_like(coeffs)), axis=0
    )
    return col_max.at[0].set(jnp.zeros((), coeffs.dtype))


@functools.partial(jax.jit, static_argnums=(1,))
def _stats_stream_device(x: jax.Array, need_range: bool):
    """One-pass global statistics on a device-resident array: (max|x|, sum,
    max, min). The sum accumulates in the array dtype (the mean is a
    stored-but-unused header field, dctz-decomp-lib.c:499,508)."""
    amax = jnp.max(jnp.abs(x))
    total = jnp.sum(x)
    if need_range:
        return amax, total, jnp.max(x), jnp.min(x)
    return amax, total, amax, amax


def _segments(x, segment_elems: int) -> Iterator:
    """Slices of `x` (numpy OR device-resident jax.Array — device slicing
    never leaves HBM)."""
    for off in range(0, x.shape[0], segment_elems):
        yield x[off : off + segment_elems]


def compress_stream(
    x: np.ndarray,
    out: BinaryIO,
    error_bound: float = 1e-3,
    mode: str = "ec",
    *,
    config: CodecConfig | None = None,
    segment_elems: int = DEFAULT_SEGMENT,
    trace: list | None = None,
) -> int:
    """Compress `x` into `out` in bounded-memory segments; returns total
    bytes written. segment_elems is rounded to a block multiple.

    trace: optional list collecting per-segment wall timestamps
    ("device"|"pull"|"pack", segment, t0, t1) from the pipelined DPK path —
    bench.py computes the MEASURED overlap fraction from these (VERDICT
    round-4 #2: the headline's overlap factor must be traceable to
    timestamps from a real run on the chip, not assumed)."""
    cfg = config or CodecConfig(mode=mode, error_bound=error_bound, container="v2")
    device_input = isinstance(x, jax.Array) and not isinstance(x, np.ndarray)
    if device_input:
        x = x.reshape(-1)
    else:
        x = np.asarray(x).reshape(-1)
    n = x.shape[0]
    if n == 0:
        raise ValueError("cannot compress an empty array")
    segment_elems = max(cfg.block_size, segment_elems - segment_elems % cfg.block_size)

    # pass 1: global statistics (the sf must see the whole array). The
    # value range is only needed for the verify tolerance (dpk path below);
    # device-resident input reduces in ONE pass on device — the data never
    # visits the host (VERDICT round-3 #4/#1).
    if device_input:
        amax_d, total_d, vmax_d, vmin_d = _stats_stream_device(x, True)
        sf = float(jax.device_get(scaling_factor(amax_d, cfg.sf_adj)))
        total, vmax, vmin = (
            float(jax.device_get(total_d)),
            float(jax.device_get(vmax_d)),
            float(jax.device_get(vmin_d)),
        )
    else:
        amax = 0.0
        total = 0.0
        vmax = -np.inf
        vmin = np.inf
        for seg in _segments(x, segment_elems):
            amax = max(amax, float(np.abs(seg).max()))
            total += float(seg.sum(dtype=np.float64))
            vmax = max(vmax, float(seg.max()))
            vmin = min(vmin, float(seg.min()))
        sf = float(
            jax.device_get(
                scaling_factor(jnp.asarray(amax, x.dtype), cfg.sf_adj)
            )
        )
    mean = total / n

    written = 0
    out.write(_HDR.pack(MAGIC, 1, 0, n))
    written += _HDR.size

    # Two-stage software pipeline: the device encodes segment k while the
    # host entropy-codes segment k-1 (device dispatches are async; the
    # blocking device_get lives in the host worker). Depth 2 bounds device
    # memory to two in-flight segments.
    import concurrent.futures

    from .api import _device_cfg

    def write_frame(blob: bytes) -> int:
        out.write(_FRAME.pack(len(blob)))
        out.write(blob)
        return _FRAME.size + len(blob)

    # verify tolerance is GLOBAL (eb * range of the whole array) — a
    # segment-local range would tighten the bound on flat segments
    from .ops import repair

    tol = (vmax - vmin) * cfg.error_bound * repair._SLACK
    bound_bad: list[int] = []  # segment indices where repair fell short

    # device-coded (DPK) frames: float32 streams at the reference block
    # size (segments pad to the _DPK_QUANTUM, a whole number of blocks)
    dpk_seg = (
        backend.device_ids(cfg)
        and x.dtype == np.float32
        and cfg.block_size == C.BLK_SZ
        and cfg.truncate
    )

    # QT: global qtable pre-pass — the quantizer table is a whole-array
    # per-position max (reference dctz-comp-lib.c:355-398), so pass 1 runs
    # over every segment FIRST and each frame then renormalizes against
    # the same global table, keeping streamed QT semantics monolithic-
    # identical (max is associative). Frames store that table with slot 0
    # patched per frame (last block DC — the decoder never reads it).
    qt_ext = None
    if cfg.mode == "qt":
        from .api import _device_cfg as _dcfg

        qm = None
        for seg in _segments(x, segment_elems):
            # DPK frames transform the zero-padded segment (whole blocks)
            xs = _pad_segment(seg) if dpk_seg else jnp.asarray(seg)
            dt = np.dtype(str(seg.dtype))
            q1 = _qtable_colmax_segment(
                xs, jnp.asarray(np.asarray(sf, dt)), int(xs.shape[0]),
                _dcfg(cfg),
            )
            qm = q1 if qm is None else jnp.maximum(qm, q1)
        qt_ext = qm

    if dpk_seg:
        # every frame is a DPK v2 container (api._pack_dpk_v2); verify-
        # repair runs inside the segment program with the GLOBAL tolerance
        with concurrent.futures.ThreadPoolExecutor(1) as host_worker:
            pending = None
            for si, seg in enumerate(_segments(x, segment_elems)):
                t0 = time.perf_counter()
                outs = _encode_segment_dpk(
                    seg, sf, tol, _device_cfg(cfg), cfg, qt_ext
                )
                if trace is not None:
                    # _encode_segment_dpk blocks on the overflow scalar, so
                    # this interval covers the segment's device execution
                    trace.append(("device", si, t0, time.perf_counter()))
                if pending is not None:
                    written += write_frame(pending.result())
                pending = host_worker.submit(
                    _pack_segment_dpk, outs, seg.shape[0],
                    np.dtype(seg.dtype), sf, mean, cfg, bound_bad, si,
                    trace,
                )
            written += write_frame(pending.result())
        out.write(_FRAME.pack(0))
        _warn_bound(bound_bad)
        return written + _FRAME.size

    with concurrent.futures.ThreadPoolExecutor(1) as host_worker:
        pending = None
        for si, seg in enumerate(_segments(x, segment_elems)):
            n_seg = int(seg.shape[0])
            dt = np.dtype(str(seg.dtype))
            sfv = jnp.asarray(np.asarray(sf, dt))
            tolv = jnp.asarray(np.asarray(tol, dt))
            q = _encode_segment(
                jnp.asarray(seg), sfv, tolv, n_seg, _device_cfg(cfg), qt_ext
            )
            if pending is not None:
                written += write_frame(pending.result())
            pending = host_worker.submit(
                _pack_segment, q, n_seg, dt, sf, mean, cfg, bound_bad, si,
            )
        written += write_frame(pending.result())
    out.write(_FRAME.pack(0))
    _warn_bound(bound_bad)
    return written + _FRAME.size


def _warn_bound(bound_bad: list) -> None:
    if bound_bad:
        import warnings

        warnings.warn(
            "verify-repair could not fully satisfy the pointwise bound in "
            f"segment(s) {bound_bad} (float32-truncation floor); see "
            "docs/numerics.md",
            stacklevel=3,
        )


#: DPK segments pad to this many elements (whole idpack tiles' worth of
#: compaction chunks; the container stores the padded length as n_stream)
_DPK_QUANTUM = 1024


def _pad_segment(seg) -> jax.Array:
    """The segment on the device, zero-padded to the _DPK_QUANTUM."""
    xs = jnp.asarray(seg)
    pad = (-xs.shape[0]) % _DPK_QUANTUM
    if pad:
        xs = jnp.concatenate([xs, jnp.zeros((pad,), xs.dtype)])
    return xs


@functools.partial(jax.jit, static_argnums=(3, 4, 5))
def _encode_segment_dpk_jit(x, sf, tol, n_valid, cfg, cape, ext_qtable=None):
    """One DPK segment on the padded array x: whole-block DCT, quantize,
    verify-repair against the global tolerance (elements >= n_valid are
    padding), then the id coder and AC compaction sharing one chunk sort
    (idpack.pack_ids_with_ac). Every position of the padded grid is
    coded: the decoder reconstructs whole zero-padded blocks.

    Returns the pack_ids_with_ac outputs, the verify flag, and the QT
    table (slot 0 = the last real block's DC, the reference quirk) or
    None."""
    from .ops import idpack, repair

    n_pad = x.shape[0]
    xs = x / sf
    coeffs = transform.block_dct_flat(
        xs, cfg.block_size, precision=backend.dct_precision(cfg.dct_precision)
    )
    ids, stored, dc, qtable = qz.quantize(
        coeffs, n_pad, cfg, ext_qtable=ext_qtable
    )
    ok = jnp.bool_(True)
    if cfg.verify:
        ids, stored, ok = repair.verify_repair(
            x, coeffs, sf, ids, dc, qtable, n_pad, n_valid, cfg, tol
        )
    if qtable is not None:
        qtable = qtable.at[0].set(coeffs[(n_valid - 1) // cfg.block_size, 0])
    outs = idpack.pack_ids_with_ac(
        ids, stored, n_pad, idpack.B_DEFAULT, cape
    )
    return outs + (ok, qtable)


def _encode_segment_dpk(
    seg, sf: float, tol: float, cfg, host_cfg: CodecConfig, qt_ext=None,
):
    """Device stage of one DPK segment (padded to the _DPK_QUANTUM);
    retries once at full chunk width on exception-capacity overflow. The
    f32 DC/AC streams leave the device as byte planes (api._plane_split2)
    so the host packer skips its shuffle pass — decided on host_cfg (the
    UN-normalized config: _device_cfg zeroes the host-side shuffle/plc
    fields, which would silently disable the split). qt_ext: the GLOBAL
    per-position escape maxima for QT segments (pass 1 over all
    segments)."""
    from .api import _plane_mode, _plane_split2
    from .ops import idpack

    n = seg.shape[0]
    xs = _pad_segment(seg)
    n_pad = xs.shape[0]
    sfv = jnp.asarray(np.asarray(sf, np.float32))
    tolv = jnp.asarray(np.asarray(tol, np.float32))
    outs = _encode_segment_dpk_jit(xs, sfv, tolv, n, cfg, idpack.CAPE, qt_ext)
    if bool(jax.device_get(outs[7])):
        outs = _encode_segment_dpk_jit(
            xs, sfv, tolv, n, cfg, qz.chunk_width(n_pad, cfg.block_size),
            qt_ext,
        )
    planes = (
        _plane_split2(
            outs[6], outs[4],
            host_cfg.dc_delta and host_cfg.container == "v2",
        )
        if _plane_mode(host_cfg, outs[6])
        else None
    )
    return outs[:9], planes, n_pad, outs[9]


def _pack_segment_dpk(
    outs_npad, n: int, dtype: np.dtype, sf: float, mean: float, cfg,
    bound_bad: list | None = None, seg_index: int = 0, trace=None,
) -> bytes:
    """Host stage of one DPK segment: pull the device results and pack the
    same v2 container the monolithic path emits (api._pack_dpk_v2).
    Runs on the writer's host worker thread; `trace` records the pull
    (device_get: device completion + transfer) and pack (pure host CPU)
    intervals separately."""
    from .api import _pack_dpk_v2

    tp0 = time.perf_counter()
    (width, packed, exc_rows, exc_counts, ac_chunks, counts, dc, _ovf,
     _ok), planes, n_pad, qt_seg = outs_npad
    dc_planes = ac_planes = None
    if planes is not None:
        width, packed, exc_rows, exc_counts, dc_planes, ac_planes, counts = (
            jax.device_get(
                (width, packed, exc_rows, exc_counts, planes[0], planes[1],
                 counts)
            )
        )
        ac_chunks = dc = None
    else:
        width, packed, exc_rows, exc_counts, ac_chunks, counts, dc = (
            jax.device_get(
                (width, packed, exc_rows, exc_counts, ac_chunks, counts, dc)
            )
        )
    if cfg.verify and bound_bad is not None and not bool(
        jax.device_get(_ok)
    ):
        bound_bad.append(seg_index)
    header = ct.Header(
        dtype=dtype,
        num_elements=n,
        error_bound=cfg.error_bound,
        ac_count=int(counts.sum()),
        scaling_factor=sf,
        mean=mean,
        bindex_nbytes=0,
        dc_nbytes=0,
        ac_nbytes=0,
        mode=cfg.mode,
        block_size=cfg.block_size,
        nbins=cfg.nbins,
        truncate=cfg.truncate,
        brsf=cfg.brsf,
    )
    qtable = (
        np.asarray(jax.device_get(qt_seg)) if qt_seg is not None else None
    )
    tp1 = time.perf_counter()
    blob = _pack_dpk_v2(
        header, width, packed, exc_rows, exc_counts, counts, ac_chunks,
        dc, n_pad, cfg, qtable, dc_planes=dc_planes, ac_planes=ac_planes,
    )
    if trace is not None:
        trace.append(("pull", seg_index, tp0, tp1))
        trace.append(("pack", seg_index, tp1, time.perf_counter()))
    return blob


def _pack_segment(
    q, n: int, dtype: np.dtype, sf: float, mean: float, cfg: CodecConfig,
    bound_bad: list | None = None, seg_index: int = 0,
) -> bytes:
    """Host stage of one segment: pull device results, entropy-code, pack
    (same filters/codecs as the monolithic v2 path)."""
    from .api import _assemble_ac, _ids_streams

    if q.bound_ok is not None and bound_bad is not None and not bool(
        jax.device_get(q.bound_ok)
    ):
        bound_bad.append(seg_index)
    ac, bin_ids, ac_count = _assemble_ac(q)
    dc = np.asarray(jax.device_get(q.dc))
    qtable = np.asarray(jax.device_get(q.qtable)) if q.qtable is not None else None

    header = ct.Header(
        dtype=dtype,
        num_elements=n,
        error_bound=cfg.error_bound,
        ac_count=ac_count,
        scaling_factor=sf,
        mean=mean,
        bindex_nbytes=0,
        dc_nbytes=0,
        ac_nbytes=0,
        mode=cfg.mode,
        block_size=cfg.block_size,
        nbins=cfg.nbins,
        truncate=cfg.truncate,
        brsf=cfg.brsf,
    )
    flat_ids = bin_ids.reshape(-1)[:n]
    header.shuffle = cfg.shuffle
    if cfg.dc_delta and dtype == np.float32 and dc.dtype == np.float32:
        # same DC delta as the monolithic v2 paths (api._dcd_on); frames
        # restart at their own item 0, so each decodes independently
        dc = entropy.f32_delta(dc)
        header.dcd = True
    dcb, acb = dc.tobytes(), ac.tobytes()
    if cfg.shuffle:
        dcb = entropy.shuffle_bytes(dcb, dc.dtype.itemsize)
        acb = entropy.shuffle_bytes(acb, ac.dtype.itemsize)
    streams = _ids_streams(flat_ids.tobytes(), cfg, header) + (
        entropy.chunked_deflate(dcb, cfg.chunk_bytes, cfg.zlib_level),
        entropy.chunked_deflate(acb, cfg.chunk_bytes, cfg.zlib_level),
    )
    return ct.pack_v2(
        header, streams, qtable if cfg.mode == "qt" else None, cfg.chunk_bytes
    )


class MemReader:
    """A minimal file-like reader over a buffer: read() returns zero-copy
    memoryview slices, so restoring a DTZS stream held in memory never
    duplicates the blob (VERDICT round-3 #5)."""

    def __init__(self, buf) -> None:
        self._mv = memoryview(buf)
        self._pos = 0

    def read(self, size: int) -> memoryview:
        view = self._mv[self._pos : self._pos + size]
        self._pos += len(view)
        return view


def _read_stream_header(f) -> int:
    """Validate the DTZS magic/version; returns total_elements."""
    hdr = bytes(f.read(_HDR.size))
    magic, version, _res, total = _HDR.unpack(hdr)
    if magic != MAGIC:
        raise ValueError("not a DCTZ-TPU stream")
    if version != 1:
        raise ValueError(f"unsupported stream version {version}")
    return total


def decompress_stream(f: BinaryIO, trace: list | None = None) -> Iterator[np.ndarray]:
    """Yield reconstructed segments in order (the bounded-memory restore
    path for arrays larger than RAM: peak incremental memory is ~one
    segment).

    Two-stage pipeline (mirror of the writer): a worker thread runs frame
    k+1's HOST stage (crc parse + side-stream inflation + row re-padding)
    while this thread runs frame k's device program — the host stage hides
    behind device compute + transfer instead of serializing with it.
    `trace` collects ("prep"|"device", frame, t0, t1) wall timestamps
    (see compress_stream)."""
    _read_stream_header(f)
    yield from _decode_frames(f, trace)


def _decode_frames(f, trace: list | None = None) -> Iterator[np.ndarray]:
    import concurrent.futures

    from .api import decompress

    def read_frame():
        raw = f.read(_FRAME.size)
        if len(raw) != _FRAME.size:
            raise ValueError("truncated stream: missing frame header")
        (length,) = _FRAME.unpack(raw)
        if not length:
            return None
        body = f.read(length)
        if len(body) != length:
            raise ValueError("truncated stream: frame body cut short")
        return body

    def prep(blob):
        """Host stage; returns a closure running the device stage (main
        thread). Frames that are not single DPK v2 containers fall back to
        a full decompress inside the worker (still overlapped)."""
        from . import api
        from .core import container as ct2

        if ct2.detect_format(blob) != "v2":
            return lambda: decompress(blob)
        header, streams, qtable, _cb = ct2.parse_v2(blob)
        if not header.dpk:
            return lambda: decompress(blob)
        host_arrays, (n_stream, tile_b, cw, cfg) = (
            api._dpk_decode_prep(header, streams)
        )
        n = header.num_elements
        work = api._decode_work_dtype(header)

        def run_device():
            dev = tuple(jnp.asarray(a) for a in host_arrays)
            sf = jnp.asarray(header.scaling_factor, jnp.dtype(work))
            qt = (
                jnp.asarray(qtable).astype(jnp.dtype(work))
                if qtable is not None
                else None
            )
            x = api._decode_device_dpk(
                *dev, n_stream, api._device_cfg(cfg), work, tile_b, cw,
                sf, qt, header.dcd,
            )
            return np.asarray(jax.device_get(x), dtype=header.dtype)[:n]

        return run_device

    def prep_traced(blob, fi):
        t0 = time.perf_counter()
        run = prep(blob)
        if trace is not None:
            trace.append(("prep", fi, t0, time.perf_counter()))
        return run

    with concurrent.futures.ThreadPoolExecutor(1) as host_worker:
        blob = read_frame()
        if blob is None:
            return
        fi = 0
        fut = host_worker.submit(prep_traced, blob, fi)
        while True:
            nxt = read_frame()
            run = fut.result()
            if nxt is not None:
                fut = host_worker.submit(prep_traced, nxt, fi + 1)
            t0 = time.perf_counter()
            part = run()
            if trace is not None:
                trace.append(("device", fi, t0, time.perf_counter()))
            yield part
            fi += 1
            if nxt is None:
                return


def decompress_stream_all(f: BinaryIO, trace: list | None = None) -> np.ndarray:
    """Reassemble the full array from a stream.

    The output buffer is allocated ONCE from the stream header's element
    count and filled per frame — peak incremental memory beyond the output
    is ~one segment (the old list+concatenate held 2x the array)."""
    total = _read_stream_header(f)
    out: np.ndarray | None = None
    off = 0
    for part in _decode_frames(f, trace):
        if out is None:
            if part.size == total:  # single-frame stream: no copy at all
                return part
            out = np.empty(total, part.dtype)
        out[off : off + part.size] = part
        off += part.size
    if out is None or off != total:
        raise ValueError(
            f"truncated stream: {off} of {total} elements restored"
        )
    return out
