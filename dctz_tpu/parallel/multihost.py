"""Multi-host (multi-process) orchestration.

Single-controller sharding lives in parallel/sharding.py; this module adds
the multi-process glue, following the standard JAX multi-host recipe. The
reference has no distributed capability at all (its only concurrency is
three pthreads, dctz-comp-lib.c:620-732).

Data flow — no host ever materializes the global array:

  * every host calls `init()` (jax.distributed.initialize from standard env
    vars or explicit coordinator address);
  * the global 1-D mesh spans all chips of all hosts; each host feeds ONLY
    its local block-aligned slice (`host_slice`) via
    `jax.make_array_from_process_local_data` — a metadata operation, not a
    gather;
  * the device program is the same sharded encode as single-host:
    encode_sharded's `lax.pmax/psum` collectives cross devices within a
    host and the network across hosts (16 B for sf/mean, 512 B for the QT table, 4 B for the
    verify flag: negligible);
  * every host then reads ONLY its addressable output shards
    (`_local_rows`), entropy-codes them, and packs ONE v2 container of its
    slice (global sf/mean, local element count) wrapped as a stream.py
    DTZS frame — `compress_multihost` returns this host's bytes (host 0's
    start with the DTZS stream header);
  * concatenating the per-host parts in process order (shared filesystem,
    object store multipart, or plain `cat`) yields a valid DTZS stream that
    a SINGLE process `dctz_tpu.decompress()` restores, and whose frames any
    subset of hosts can restore independently (partial decode).

CI exercises the real multi-process path with 2 `jax.distributed` CPU
processes (tests/test_multihost.py) plus the single-process degenerate path;
`__graft_entry__.dryrun_multichip` compiles the same program on a virtual
8-device mesh.
"""

from __future__ import annotations

import dataclasses

import numpy as np

import jax

from ..config import CodecConfig
from ..core import container as ct
from ..core import entropy
from . import sharding as sh


def init(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize jax.distributed (no-op when already initialized or when
    running single-process)."""
    if jax.process_count() > 1:
        return  # already initialized by the launcher
    if coordinator_address is None and num_processes is None:
        return  # single-process run
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def host_slice(
    n_total: int, block_size: int = 64, quantum_blocks: int = 1
) -> tuple[int, int]:
    """[start, stop) of this host's contiguous block-aligned share of the
    PADDED flat array (zero-padding beyond n_total is the caller's to fill).

    quantum_blocks: pass ops.idpack.B_DEFAULT when compressing with
    ids_codec="device" so tiles never cross shards."""
    nproc = jax.process_count()
    pid = jax.process_index()
    n_pad = sh.padded_size(
        n_total, jax.device_count(), block_size, quantum_blocks
    )
    per_host = n_pad // nproc
    assert per_host % block_size == 0
    return pid * per_host, (pid + 1) * per_host


def _local_rows(arr) -> np.ndarray:
    """Concatenate this process's addressable shards in global row order —
    the only device->host transfer a host performs."""
    shards = sorted(
        arr.addressable_shards, key=lambda s: s.index[0].start or 0
    )
    return np.concatenate([np.asarray(s.data) for s in shards], axis=0)


def _pack_local_container(
    bin_ids_l: np.ndarray,
    dc_l: np.ndarray,
    ac_l: np.ndarray,
    n_local: int,
    src_dtype: np.dtype,
    sf: float,
    mean: float,
    qtable: np.ndarray | None,
    cfg: CodecConfig,
    dpk_parts: tuple | None = None,
    shard_elems: int = 0,
) -> bytes:
    """One host's slice -> v2 container (global sf/mean, local length).

    dpk_parts: this host's (width, packed_rows, exc_rows, exc_counts,
    ac_counts) from the per-shard device id coder — the frame then carries
    device-coded ids and the host never touches the raw id stream."""
    header = ct.Header(
        dtype=src_dtype,
        num_elements=n_local,
        error_bound=cfg.error_bound,
        ac_count=len(ac_l),
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
    header.shuffle = cfg.shuffle
    from ..api import _dpk_sections, _ids_streams
    from ..core import quantize as qz

    dcb, acb = dc_l.tobytes(), np.asarray(ac_l).tobytes()
    if cfg.shuffle:
        dcb = entropy.shuffle_bytes(dcb, dc_l.dtype.itemsize)
        acb = entropy.shuffle_bytes(acb, np.asarray(ac_l).dtype.itemsize)
    dc_ac_z = (
        entropy.chunked_deflate(dcb, cfg.chunk_bytes, cfg.zlib_level),
        entropy.chunked_deflate(acb, cfg.chunk_bytes, cfg.zlib_level),
    )
    if dpk_parts is not None:
        from ..ops import idpack

        width_l, packed_l, exc_rows_l, exc_counts_l, ac_counts_l = dpk_parts
        streams = _dpk_sections(
            width_l,
            packed_l,
            exc_rows_l,
            exc_counts_l,
            ac_counts_l,
            idpack.B_DEFAULT,
            qz.chunk_width(shard_elems, cfg.block_size),
            bin_ids_l.size,  # host-local padded stream length
            cfg,
            header,
        ) + dc_ac_z
    else:
        streams = (
            _ids_streams(bin_ids_l.reshape(-1).tobytes(), cfg, header)
            + dc_ac_z
        )
    return ct.pack_v2(
        header, streams, qtable if cfg.mode == "qt" else None, cfg.chunk_bytes
    )


def compress_multihost(
    local: np.ndarray,
    n_total: int,
    error_bound: float = 1e-3,
    mode: str = "ec",
    *,
    config: CodecConfig | None = None,
) -> bytes:
    """Compress a distributed array; returns THIS HOST's bytes of the global
    DTZS stream (host 0's include the stream header; every host appends one
    frame). Concatenated in process order the parts form a stream that
    `dctz_tpu.decompress()` restores in one process.

    `local` is this host's slice per `host_slice(n_total)` — the last host
    may pass fewer elements than its slice; the remainder is zero-padded
    here. Single-process runs degenerate to api.compress_sharded.
    """
    import struct

    from .. import stream as dstream

    cfg = config or CodecConfig(
        mode=mode, error_bound=error_bound, container="v2"
    )
    if cfg.container != "v2":
        cfg = dataclasses.replace(cfg, container="v2")
    if jax.process_count() == 1:
        from ..api import compress_sharded

        blob = compress_sharded(local, config=cfg)
        head = dstream._HDR.pack(dstream.MAGIC, 1, 0, n_total)
        return (
            head
            + dstream._FRAME.pack(len(blob))
            + blob
            + dstream._FRAME.pack(0)
        )

    from ..ops import idpack

    from .. import backend

    dpk = backend.device_ids(cfg)
    quantum = idpack.B_DEFAULT if dpk else 1
    pid = jax.process_index()
    nproc = jax.process_count()
    src_dtype = np.dtype(getattr(local, "dtype", np.float64))
    local = np.asarray(local).reshape(-1)
    if local.dtype == np.float64 and not jax.config.jax_enable_x64:
        local = local.astype(np.float32)

    lo, hi = host_slice(n_total, cfg.block_size, quantum)
    share = hi - lo
    if local.shape[0] < share:  # zero-pad the tail host's slice
        local = np.concatenate(
            [local, np.zeros(share - local.shape[0], local.dtype)]
        )
    if local.shape[0] != share:
        raise ValueError(
            f"host {pid} got {local.shape[0]} elements, expected <= {share} "
            f"(host_slice of {n_total})"
        )
    n_local_real = max(0, min(n_total - lo, share))

    mesh = sh.make_mesh()  # all global devices
    n_pad = sh.padded_size(
        n_total, jax.device_count(), cfg.block_size, quantum
    )
    from jax.sharding import NamedSharding, PartitionSpec as P

    garr = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P(sh.AXIS)), local, global_shape=(n_pad,)
    )

    n_dev = mesh.devices.size

    def run(cape=None):
        return sh.encode_sharded(
            garr,
            n_real=n_total,
            cfg=_mh_device_cfg(cfg),
            mesh=mesh,
            dpk=dpk,
            cape=cape,
        )

    out = run()
    if dpk and int(jax.device_get(out[-1])) != 0:
        out = run(1 << 20)  # exception-capacity overflow: full chunk width
    base, extra = out[:8], out[8:]
    bin_ids, dc, ac_bufs, ac_counts, sf, mean, qtable, _ok = base
    dpk_parts = None
    if dpk:
        dpk_parts = tuple(_local_rows(a) for a in extra[:5])

    # addressable shards only — each host holds exactly its slice's rows
    bin_ids_l = _local_rows(bin_ids)
    dc_l = _local_rows(dc)
    rows_l = _local_rows(ac_bufs)
    counts_l = _local_rows(ac_counts)
    ac_l = (
        np.concatenate(
            [rows_l[d, : int(counts_l[d])] for d in range(rows_l.shape[0])]
        )
        if counts_l.sum()
        else np.zeros((0,), rows_l.dtype)
    )
    sf_v = float(jax.device_get(sf))
    mean_v = float(jax.device_get(mean))
    qt = (
        np.asarray(jax.device_get(qtable)) if cfg.mode == "qt" else None
    )

    parts = []
    if pid == 0:
        parts.append(dstream._HDR.pack(dstream.MAGIC, 1, 0, n_total))
    if n_local_real > 0:  # all-padding hosts contribute no frame
        blob = _pack_local_container(
            bin_ids_l, dc_l, ac_l, n_local_real, src_dtype, sf_v, mean_v, qt,
            cfg, dpk_parts, n_pad // n_dev,
        )
        parts.append(dstream._FRAME.pack(len(blob)))
        parts.append(blob)
    if pid == nproc - 1:
        parts.append(dstream._FRAME.pack(0))
    return b"".join(parts)


def _mh_device_cfg(cfg: CodecConfig) -> CodecConfig:
    from ..api import _device_cfg

    return _device_cfg(cfg)


# ---------------------------------------------------------------------------
# distributed restore
# ---------------------------------------------------------------------------


class LocalRestore(tuple):
    """(data, start, frames): this host's reconstructed slice, its global
    element offset, and the indices of the stream frames it decoded."""

    __slots__ = ()

    def __new__(cls, data, start, frames):
        return tuple.__new__(cls, (data, start, frames))

    data = property(lambda self: self[0])
    start = property(lambda self: self[1])
    frames = property(lambda self: self[2])


def _scan_frames(data: memoryview):
    """DTZS layout scan without decoding: returns (n_total, [(off, len,
    n_elements, block_size, dpk), ...]). Each frame is a v2 container whose
    fixed header carries its element count."""
    from .. import stream as dstream

    magic, version, _res, n_total = dstream._HDR.unpack_from(data, 0)
    if magic != dstream.MAGIC:
        raise ValueError("not a DCTZ-TPU stream")
    if version != 1:
        raise ValueError(f"unsupported stream version {version}")
    frames = []
    off = dstream._HDR.size
    while True:
        (length,) = dstream._FRAME.unpack_from(data, off)
        off += dstream._FRAME.size
        if length == 0:
            break
        import struct

        (fmagic, _v, flags, n, _eb, _sf, _mean, _acc, _nb, bs, _r, _cb) = (
            struct.unpack_from(ct._V2_FIXED_FMT, data, off)
        )
        if fmagic != ct.V2_MAGIC:
            raise ValueError("DTZS frame is not a v2 container")
        frames.append((off, length, n, bs, bool(flags & ct._FLAG_DPK)))
        off += length
    return n_total, frames


def decompress_multihost(stream: bytes | memoryview) -> LocalRestore:
    """Inverse of compress_multihost: restore THIS HOST's slice of a DTZS
    stream. Each host scans the frame table (headers only), computes its
    host_slice, and decodes ONLY the frames overlapping it — no host
    touches another host's frame data when the restoring process count
    matches the writer's (frames are per-host and slice-aligned); with a
    different process count, overlapping frames are decoded and sliced.

    MONOLITHIC containers restore too: a v2 DPK container decodes by tile
    range (api._decompress_dpk_range — each host touches only its share of
    the bulk packed section, zero-copy on verbatim containers), so one big
    single-shot container written anywhere can be restored in parallel by
    several hosts. Other monolithic formats (generic v2, v1) fall back to
    full-decode-and-slice per host: correct, but every host pays the whole
    decode.

    Single-process runs restore the whole array (start == 0). The reference
    has no distributed capability; this closes the save->restore loop of
    the checkpoint story at the same scale as compress_multihost.
    """
    from ..api import decompress
    from ..ops import idpack

    data = memoryview(stream)
    if bytes(data[:4]) != b"DTZS":
        return _decompress_monolithic_local(data)
    n_total, frames = _scan_frames(data)
    if not frames:
        return LocalRestore(np.zeros((0,), np.float32), 0, ())

    bs = frames[0][3]
    quantum = idpack.B_DEFAULT if frames[0][4] else 1
    if jax.process_count() == 1:
        lo, hi = 0, n_total
    else:
        lo, hi = host_slice(n_total, bs, quantum)
    hi = min(hi, n_total)

    pieces: list[np.ndarray] = []
    used: list[int] = []
    span_lo = 0
    for k, (off, length, n_frame, _bs, _dpk) in enumerate(frames):
        span_hi = span_lo + n_frame
        if span_hi > lo and span_lo < hi:
            seg = decompress(bytes(data[off : off + length]))
            a = max(lo, span_lo) - span_lo
            b = min(hi, span_hi) - span_lo
            pieces.append(seg[a:b])
            used.append(k)
        span_lo = span_hi
        if span_lo >= hi:
            break
    if not pieces:  # all-padding host: nothing real in its slice
        return LocalRestore(np.zeros((0,), np.float32), lo, ())
    local = np.concatenate(pieces) if len(pieces) != 1 else pieces[0]
    return LocalRestore(local, lo, tuple(used))


def _decompress_monolithic_local(data: memoryview) -> LocalRestore:
    """This host's slice of a MONOLITHIC container (not a DTZS stream).

    v2 DPK containers decode by tile range — the bulk packed section, the
    DC/AC plane chunks, the crc verification (deferred parse), and ALL
    device work cover just this host's tiles; only the small side-section
    parses (meta/width tables, O(n/256)) span the container. Generic v2 /
    v1 containers (no per-chunk counts to slice the AC stream by) decode
    fully on every host and slice.
    """
    from ..api import _decompress_dpk_range, _dpk_meta, decompress
    from ..ops import idpack

    if jax.process_count() == 1:
        out = decompress(data)  # decompress takes memoryviews — no copy
        return LocalRestore(out, 0, ())

    header = None
    if ct.detect_format(data) == "v2":
        # defer the payload crc sweep: the tile-range path verifies exactly
        # the chunks it touches (entropy.verify_chunk_range), so per-host
        # crc work is O(range), not O(container). The generic fallback
        # below re-parses inside decompress() with the full sweep.
        header, streams, qtable, _cb = ct.parse_v2(data, chunk_crcs="defer")
    if header is not None and header.dpk:
        n_stream, tile_b, cw, meta = _dpk_meta(
            header, streams, with_bytes=True
        )
        bs = header.block_size
        n = header.num_elements
        nblk = -(-n_stream // bs)
        t_total = idpack.tiles_of(nblk, tile_b)
        lo, hi = host_slice(n, bs, tile_b)
        te = tile_b * bs
        t0 = min(lo // te, t_total)
        t1 = min(-(-hi // te), t_total)
        if t0 >= t1 or lo >= n:  # all-padding host
            return LocalRestore(np.zeros((0,), header.dtype), lo, ())
        local = _decompress_dpk_range(
            header, streams, qtable, t0, t1, meta=meta
        )
        a = lo - t0 * te
        b = min(hi, n) - t0 * te
        return LocalRestore(local[a:b], lo, ())

    # generic v2 / v1 fallback: full decode, slice
    out = decompress(data)
    bs = header.block_size if header is not None else 64
    lo, hi = host_slice(out.size, bs, 1)
    if lo >= out.size:
        return LocalRestore(np.zeros((0,), out.dtype), lo, ())
    return LocalRestore(out[lo : min(hi, out.size)], lo, ())
