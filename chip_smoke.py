#!/usr/bin/env python
"""Smoke test of the codec on an NVIDIA GPU, through its public entry points.

    python chip_smoke.py              # one card: every phase below
    python chip_smoke.py --chips 4    # four cards: the sharded path only

One card, in one process (the CLI phase is a child process, see below):

  1. device  — JAX's default device must be a GPU (no CPU fallback); prints
               device_kind, count, JAX version, the card's name and power
               limit, and what the host stage resolved (zstd, native lib).
  2. cli     — `python -m dctz_tpu.cli -f 1E-3 ... --container v2 --json` on
               a CESM-ATM-shaped 1800x3600 float32 field.
  3. main    — 2**25 float32 climate-formula elements, EC 1e-3, v2,
               verify=True, default (pipelined) path, from a host array and
               from a device array, ids_codec "device" and "auto".
  4. qt      — the same array in QT mode.
  5. f64     — 2**23 float64 elements at EB_MIN through v2 (x64 on), and
               the MSST'19-sized float64 arrays into v1 containers,
               byte-identical to the native oracle apart from the mean.
  6. large   — 2**28 float32 elements (1 GiB) held on the card, default
               pipelined path.
  7. numerics — the card's DCT, DPK pack and bin ids against plain
               references (tolerances stated where they are checked).

Four cards (--chips 4): compress_sharded / decompress_sharded of 2**27
float32 elements over a 1-D mesh, compared with the single-card codec.

Every phase prints one JSON line; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}. Any
failed phase makes the script exit non-zero without that line. Data comes
from --seed and closed-form generators; nothing is downloaded.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

import dctz_tpu
from dctz_tpu import api, backend, native
from dctz_tpu.config import CodecConfig
from dctz_tpu.core import constants as C
from dctz_tpu.core import entropy
from dctz_tpu.core.container import canonical
from dctz_tpu.eval.datasets import MSST19, climate_formula
from dctz_tpu.tools.rand_gen import generate
from dctz_tpu.utils.cache import enable_compile_cache

REPO = pathlib.Path(__file__).resolve().parent
EB = 1e-3
# element counts of each phase (realistic sizes; see the module docstring)
CESM_SHAPE = (1800, 3600)
N_MAIN = 1 << 25  # 128 MB float32
N_F64 = 1 << 23  # 64 MB float64
N_LARGE = 1 << 28  # 1 GiB float32
N_DCT_BLOCKS = 1 << 20
N_PACK = 1 << 24
N_IDS = 1 << 20
N_SHARDED = 1 << 27  # 512 MB float32


_T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line per phase; `at_s` is the time since the script started
    (compilation included)."""
    at = round(time.perf_counter() - _T0, 1)
    print(json.dumps({"phase": phase, "at_s": at, **fields}, default=float),
          flush=True)


def card_name_and_power_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def check_bound(phase: str, x, y, eb: float, nbytes: int) -> dict:
    m = dctz_tpu.evaluate(np.asarray(x), np.asarray(y), eb, nbytes)
    if not (m["bound_satisfied"] and m["max_rel_err"] <= eb):
        raise AssertionError(f"{phase}: bound violated {m}")
    return m


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def progress(step: str) -> None:
    """A step reached, on stderr: a run cut by its time limit shows where."""
    at = round(time.perf_counter() - _T0, 1)
    print(f"[{at} s] {step}", file=sys.stderr, flush=True)


def phase_cli(seed: int) -> None:
    """The reference-protocol CLI as a child process. It runs BEFORE this
    process initialises JAX's GPU backend: a JAX process reserves most of
    the card's memory when it starts, so the child must have the card to
    itself (the parent has only probed the card through nvidia-smi)."""
    x = generate(int(np.prod(CESM_SHAPE)), "climate", seed).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        src = pathlib.Path(tmp) / "cesm_1800x3600.f32"
        x.tofile(src)
        r = subprocess.run(
            [sys.executable, "-m", "dctz_tpu.cli", "-f", "1E-3", "var",
             str(src), str(x.size), "--container", "v2", "--json"],
            cwd=REPO, capture_output=True, text=True, timeout=600,
        )
    if r.returncode != 0:
        raise RuntimeError(f"cli failed rc={r.returncode}: {r.stderr[-2000:]}")
    m = json.loads(next(ln for ln in r.stdout.splitlines() if ln.startswith("{")))
    if not m["bound_satisfied"] or m["ratio"] <= 1.0:
        raise AssertionError(f"cli: {m}")
    emit("cli", shape=list(CESM_SHAPE), ratio=m["ratio"],
         max_rel_err=m["max_rel_err"], bound_satisfied=m["bound_satisfied"],
         compress_s=m["compress_s"], decompress_s=m["decompress_s"])


def phase_device(card: str):
    import jax

    dev = backend.require_accelerator()
    if dev.platform != "gpu":
        raise RuntimeError(f"expected a GPU, JAX found {dev.platform}")
    native.available()  # builds cpp/libdctzref.so (make -C cpp) on first use
    emit("device", platform=dev.platform, kind=dev.device_kind,
         count=len(jax.devices()), jax=jax.__version__, card=card,
         zstd_available=entropy.zstd_available(),
         native_available=native.available())
    return dev


def roundtrip(x, cfg: CodecConfig, label: str, card: str, truth=None,
              stream: bool = True) -> dict:
    """compress + decompress twice (cold, then warm) and check the bound
    on the full array; `truth` is the host copy of a device input.
    `stream`: whether compress must have taken the pipelined DTZS path."""
    for when in ("cold", "warm"):
        blob, t_c = timed(lambda: dctz_tpu.compress(x, config=cfg))
        y, t_d = timed(lambda: dctz_tpu.decompress(blob))
        progress(f"{label} {when}: {t_c:.3f} s / {t_d:.3f} s")
    m = check_bound(label, x if truth is None else truth, y,
                    cfg.error_bound, len(blob))
    is_stream = bytes(blob[:4]) == b"DTZS"
    if is_stream != stream:
        raise AssertionError(f"{label}: DTZS stream {is_stream}, want {stream}")
    return {"case": label, "ratio": m["ratio"],
            "max_rel_err": m["max_rel_err"], "bound_satisfied": True,
            "compress_s": t_c, "decompress_s": t_d,
            "stream": is_stream, "card": card}


def phase_main(card: str) -> None:
    import jax
    import jax.numpy as jnp

    n = N_MAIN
    x_np = climate_formula(n)
    x_dev = jax.block_until_ready(jnp.asarray(x_np))
    for ids_codec in ("device", "auto"):
        cfg = CodecConfig(mode="ec", error_bound=EB, container="v2",
                          verify=True, ids_codec=ids_codec)
        for src, x in (("host", x_np), ("device", x_dev)):
            r = roundtrip(x, cfg, f"ec/{ids_codec}/{src}", card, truth=x_np)
            emit("main", n=n, **r)
    cfg = CodecConfig(mode="qt", error_bound=EB, container="v2", verify=True)
    emit("qt", n=n, **roundtrip(x_np, cfg, "qt/auto/host", card))


def phase_f64(seed: int, card: str) -> None:
    import jax

    jax.config.update("jax_enable_x64", True)
    try:
        n = N_F64
        x = generate(n, "climate", seed)  # float64
        cfg = CodecConfig(mode="ec", error_bound=C.EB_MIN, container="v2",
                          verify=True)
        # 2**23 < stream.AUTO_THRESHOLD: one v2 container
        r = roundtrip(x, cfg, "f64/ec/EB_MIN", card, stream=False)
        emit("f64", n=n, dtype="float64", **r)
        # v1 parity with the native oracle: byte-identical except the
        # decoder-ignored mean (bytes 32-40, summation order differs)
        if not native.available():
            raise RuntimeError("native oracle did not build (make -C cpp)")
        for ds in MSST19:
            x = ds.load()
            for mode in ("ec", "qt"):
                jb = bytearray(dctz_tpu.compress(x, 1e-3, mode))
                nb = bytearray(native.compress(x, 1e-3, mode))
                jb[32:40] = nb[32:40] = b"\0" * 8
                if mode == "qt":
                    # the raw qtable tail may differ by 1 ulp (a max over
                    # coefficients whose summation order differs); the
                    # coded streams and the header must match exactly
                    from dctz_tpu.core import container as ct

                    hj, bj, dj, aj, qj = ct.parse_v1(bytes(jb))
                    hn, bn, dn, an, qn = ct.parse_v1(bytes(nb))
                    same = (bj, dj, aj) == (bn, dn, an) and jb[:56] == nb[:56]
                    np.testing.assert_allclose(qj, qn, rtol=1e-15)
                else:
                    same = jb == nb
                if not same:
                    raise AssertionError(f"v1 parity: {ds.name}/{mode}")
        emit("f64_parity", arrays=[ds.name for ds in MSST19],
             sizes=[ds.n for ds in MSST19], modes=["ec", "qt"],
             byte_identical_except_mean=True)
    finally:
        jax.config.update("jax_enable_x64", False)


def phase_large(card: str) -> None:
    import jax
    import jax.numpy as jnp

    n = N_LARGE
    x = jax.jit(climate_formula, static_argnums=(0, 1))(n, jnp)
    x = jax.block_until_ready(x)
    truth = np.asarray(x)
    cfg = CodecConfig(mode="ec", error_bound=EB, container="v2", verify=True)
    emit("large", n=n, **roundtrip(x, cfg, "ec/auto/device-1GiB", card,
                                   truth=truth))


def phase_numerics(seed: int) -> None:
    import jax
    import jax.numpy as jnp
    import scipy.fft

    from dctz_tpu.core import quantize as qz
    from dctz_tpu.core import transform
    from dctz_tpu.ops import idpack

    rng = np.random.default_rng(seed)
    # (a) forward DCT, 2**20 blocks, against SciPy in float64. Tolerance
    # 1e-5 * max|x|: true float32 accumulates ~64 * 2**-24 relative; TF32
    # (~2**-11 per product) would miss it by ~100x.
    xb = (rng.standard_normal((N_DCT_BLOCKS, 64)) * 100).astype(np.float32)
    ref = scipy.fft.dct(xb.astype(np.float64), type=2, norm="ortho", axis=-1)
    amax = float(np.abs(xb).max())
    errs = {}
    for name in ("highest", "high"):
        got = jax.jit(
            lambda b, p=backend.dct_precision(name): transform.block_dct(
                b, precision=p
            )
        )(jnp.asarray(xb))
        errs[name] = float(np.abs(np.asarray(got, np.float64) - ref).max())
    # "high" = BF16_BF16_F32_X3: ~2**-16 per product, ~2e-5 * max|x| over a
    # 64-term row; TF32 would be ~7e-4 * max|x|.
    if errs["highest"] > 1e-5 * amax or not errs["high"] <= 1e-4 * amax:
        raise AssertionError(f"dct error {errs} (max|x| {amax})")
    emit("numerics_dct", blocks=N_DCT_BLOCKS, max_abs_err=errs["highest"],
         max_abs_err_high_bf16x3=errs["high"], limit=1e-5 * amax)

    # (b) the XLA DPK pack against the NumPy oracle: integer-exact, so the
    # host-assembled bytes must be identical.
    n = N_PACK
    x = jnp.asarray(climate_formula(n))
    cfg = api._device_cfg(CodecConfig(error_bound=EB))

    @jax.jit
    def ids_and_stored(x):
        sf = jnp.max(jnp.abs(x)) / 4.0
        coeffs = transform.block_dct_flat(x / sf, 64)
        ids, stored, _dc, _qt = qz.quantize(coeffs, n, cfg)
        return ids, stored

    ids, stored = ids_and_stored(x)
    cw = qz.chunk_width(n, 64)
    out = idpack.pack_ids_with_ac(ids, stored, n, idpack.B_DEFAULT, idpack.CAPE)
    if bool(out[7]):
        out = idpack.pack_ids_with_ac(ids, stored, n, idpack.B_DEFAULT, cw)
    width, packed, exc_rows, exc_counts = (np.asarray(a) for a in out[:4])
    w_np, packed_np, exc_np, counts_np = idpack.pack_ids_np(
        np.asarray(ids), n, idpack.B_DEFAULT
    )
    bpr = idpack.packed_nbytes(width.reshape(-1), idpack.B_DEFAULT)
    same = (
        np.array_equal(width, w_np)
        and entropy.take_row_prefixes(packed, bpr).tobytes() == packed_np
        and entropy.take_row_prefixes(exc_rows, exc_counts).tobytes() == exc_np
        and np.array_equal(exc_counts, counts_np)
    )
    if not same:
        raise AssertionError("pack_ids_with_ac != pack_ids_np")
    emit("numerics_dpk_pack", n=n, bytes_identical=True,
         packed_bytes=len(packed_np), exception_bytes=len(exc_np))

    # (c) bin ids of the real encode program on the card vs the same jitted
    # program on the CPU, same process. Ids may differ only where a
    # coefficient sits on a bin edge (the two backends sum the DCT in other
    # orders); both encodings must decode within the bound, through the
    # per-chunk AC rows and the decode program that decompress() runs.
    n = N_IDS
    xh = climate_formula(n)
    vcfg = api._device_cfg(CodecConfig(error_bound=EB, verify=True))
    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    q_gpu, s_gpu = api._encode_device(jnp.asarray(xh), n, vcfg)
    q_cpu, s_cpu = api._encode_device(jax.device_put(xh, cpu), n, vcfg)
    diff = int(np.sum(np.asarray(q_gpu.bin_ids) != np.asarray(q_cpu.bin_ids)))
    for q, s in ((q_gpu, s_gpu), (q_cpu, s_cpu)):
        ids = np.asarray(q.bin_ids)
        cw = qz.chunk_width(ids.size, 64)
        counts = api._chunk_escape_counts(ids.reshape(-1), cw, 64)
        ac = np.asarray(q.ac_buf)[: int(q.ac_count)]
        rows = entropy.pad_row_prefixes(
            ac, counts, api._capc_tier(int(counts.max()), cw), ac.dtype
        )
        y = api._decode_device(
            *jax.device_put((ids, np.asarray(q.dc), rows), gpu), n, vcfg,
            "float32", False, jax.device_put(np.asarray(s.sf), gpu), None,
        )
        check_bound("numerics_ids", xh, y, EB, 1)
    emit("numerics_ids", n=n, ids_differing=diff, of=n,
         both_decode_within_bound=True)


def phase_sharded(card: str) -> None:
    """compress_sharded / decompress_sharded over all cards of this host,
    with the device id coder (DPK container) and the default host coder,
    each compared with the single-card codec on the first card."""
    import jax

    from dctz_tpu.parallel import sharding as sh

    devs = jax.devices()
    if len(devs) != 4:
        raise RuntimeError(f"--chips 4 needs four GPUs, JAX found {devs}")
    n = N_SHARDED
    x = climate_formula(n)
    mesh = sh.make_mesh(devs)
    for ids_codec in ("device", "auto"):
        cfg = CodecConfig(mode="ec", error_bound=EB, container="v2",
                          verify=True, ids_codec=ids_codec, segment_elems=0)
        t = {}
        for when in ("cold", "warm"):  # cold includes compilation
            sharded, t[f"compress_sharded_{when}_s"] = timed(
                lambda: dctz_tpu.compress_sharded(x, config=cfg, mesh=mesh)
            )
            progress(f"{ids_codec} compress_sharded {when}")
            y4, t[f"decompress_sharded_{when}_s"] = timed(
                lambda: dctz_tpu.decompress_sharded(sharded, mesh=mesh)
            )
            progress(f"{ids_codec} decompress_sharded {when}")
        single, t["compress_single_s"] = timed(
            lambda: dctz_tpu.compress(x, config=cfg)
        )
        y1, t["decompress_single_s"] = timed(
            lambda: dctz_tpu.decompress(sharded)
        )
        progress(f"{ids_codec} single card")
        # the mean is summed in another order per shard and never decoded
        if canonical(single) != canonical(sharded):
            raise AssertionError(f"{ids_codec}: sharded != single-card container")
        if not np.array_equal(y1, y4):
            raise AssertionError(
                f"{ids_codec}: decompress_sharded != single-card decompress"
            )
        m = check_bound(f"sharded/{ids_codec}", x, y4, EB, len(sharded))
        # where the work ran: the devices of the sharded encode's output
        # shards (the program compress_sharded ran, from its compile cache)
        dpk = ids_codec == "device"
        x_sh, _ = sh.shard_input(x, mesh, cfg.block_size, 256 if dpk else 1)
        ids = sh.encode_sharded(
            x_sh, n_real=n, cfg=api._device_cfg(cfg), mesh=mesh,
            dpk=dpk,
        )[0]
        emit("sharded", n=n, ids_codec=ids_codec, cards=len(devs),
             ratio=m["ratio"], max_rel_err=m["max_rel_err"],
             bound_satisfied=True, streams_equal_single_card=True,
             decode_equal_single_card=True,
             shard_devices=[str(s.device) for s in ids.addressable_shards],
             **t, card=card)
        del sharded, single, y1, y4, ids, x_sh


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--chips", type=int, choices=(1, 4), default=1)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()

    enable_compile_cache()
    card = card_name_and_power_limit()  # fails where there is no NVIDIA GPU
    if args.chips == 4:
        dev = phase_device(card)
        phase_sharded(card)
        count = 4
    else:
        phase_cli(args.seed)  # before this process opens the card
        dev = phase_device(card)
        phase_main(card)
        phase_large(card)
        phase_numerics(args.seed)
        phase_f64(args.seed, card)
        count = 1
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
