"""Verify-repair (ops/repair.py): guaranteed pointwise bound satisfaction.

The reference's own pointwise check is shipped disabled (util.c:96-102) and
fails on spiky data; cfg.verify=True must close exactly those failures."""

import numpy as np
import pytest

import dctz_tpu
from dctz_tpu.config import CodecConfig
from dctz_tpu.eval.datasets import SUITES


def _load(name):
    for ds in SUITES["msst19"] + SUITES["randgen"]:
        if ds.name == name:
            return ds.load()
    raise KeyError(name)


@pytest.mark.parametrize("mode", ["ec", "qt"])
@pytest.mark.parametrize("eb", [1e-3, 1e-4])
def test_sedov_violations_repaired(mode, eb):
    """sedov synthetic: the canonical pointwise-bound violator."""
    x = _load("sedov")
    y0 = dctz_tpu.decompress(dctz_tpu.compress(x, eb, mode))
    assert not dctz_tpu.evaluate(x, y0, eb)["bound_satisfied"]  # the bug

    cfg = CodecConfig(mode=mode, error_bound=eb, verify=True)
    blob = dctz_tpu.compress(x, config=cfg)
    y = dctz_tpu.decompress(blob)
    assert dctz_tpu.evaluate(x, y, eb)["bound_satisfied"]
    # ratio cost must be marginal on real-shaped data
    blob0 = dctz_tpu.compress(x, eb, mode)
    assert len(blob) < len(blob0) * 1.05


def test_random_worst_case_repaired():
    """Pure random integers: the documented worst case (BASELINE.md) — the
    guarantee must hold even at its (larger) ratio cost."""
    x = _load("randgen-1M")[:200_000]
    cfg = CodecConfig(mode="ec", error_bound=1e-3, verify=True)
    y = dctz_tpu.decompress(dctz_tpu.compress(x, config=cfg))
    assert dctz_tpu.evaluate(x, y, 1e-3)["bound_satisfied"]


def test_verify_noop_when_bound_already_holds():
    """No violations -> identical container bytes (repair must not perturb
    reference-parity streams)."""
    x = _load("rlds")
    a = dctz_tpu.compress(x, config=CodecConfig(error_bound=1e-3))
    b = dctz_tpu.compress(x, config=CodecConfig(error_bound=1e-3, verify=True))
    assert a == b


def test_verify_with_dpk_container():
    """Repair composes with the device-packed id stream."""
    x = _load("sedov").astype(np.float32)
    cfg = CodecConfig(
        mode="ec",
        error_bound=1e-3,
        verify=True,
        container="v2",
        ids_codec="device",
    )
    y = dctz_tpu.decompress(dctz_tpu.compress(x, config=cfg))
    assert dctz_tpu.evaluate(x, y, 1e-3)["bound_satisfied"]


def test_sharded_verify_repairs_bound():
    """Sharded encode with verify: global-range tol via pmax/pmin, repair
    shard-local, all-shards ok flag."""
    from dctz_tpu import compress_sharded
    from dctz_tpu.parallel import sharding as sh

    x = _load("sedov")
    mesh = sh.make_mesh()
    y0 = dctz_tpu.decompress(compress_sharded(x, 1e-3, "ec", mesh=mesh))
    assert not dctz_tpu.evaluate(x, y0, 1e-3)["bound_satisfied"]

    cfg = CodecConfig(mode="ec", error_bound=1e-3, container="v2", verify=True)
    y = dctz_tpu.decompress(compress_sharded(x, config=cfg, mesh=mesh))
    assert dctz_tpu.evaluate(x, y, 1e-3)["bound_satisfied"]


def test_repair_chunked_decode():
    """verify_repair's (ids, stored) outputs packed as a DPK stream segment
    does (idpack.pack_ids_with_ac) and decoded through the chunked AC rows
    hold the bound on the canonical violator."""
    import jax.numpy as jnp

    from dctz_tpu import api
    from dctz_tpu.core import quantize as qz
    from dctz_tpu.core import transform
    from dctz_tpu.ops import idpack, repair

    x64 = _load("sedov")
    n = (x64.size // 1024) * 1024
    x = jnp.asarray(x64[:n].astype(np.float32))
    cfg = api._device_cfg(CodecConfig(mode="ec", error_bound=1e-3))
    sf = jnp.max(jnp.abs(x)) / 4.0
    coeffs = transform.block_dct_flat(x / sf, 64)
    ids, stored, dc, qt = qz.quantize(coeffs, n, cfg)
    ids2, stored2, ok = repair.verify_repair(
        x, coeffs, sf, ids, dc, qt, n, n, cfg
    )
    assert bool(ok)
    w, pk, exc, _ec, ac_rows, _acn, dc2, ovf = idpack.pack_ids_with_ac(
        ids2, stored2, n, idpack.B_DEFAULT, 1 << 20
    )
    assert not bool(ovf)
    cw = qz.chunk_width(n, 64)
    y = api._decode_device_dpk(
        w, pk, exc, dc2, ac_rows, n, cfg, "float32",
        idpack.B_DEFAULT, cw, sf, None,
    )
    assert dctz_tpu.evaluate(np.asarray(x), np.asarray(y), 1e-3)[
        "bound_satisfied"
    ]
