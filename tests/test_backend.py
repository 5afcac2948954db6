"""The device-path policy (dctz_tpu/backend.py), the compile-cache helper
(utils/cache.py) and the float32 precision of the narrow DCT.

The same checks on the card (its DCT against SciPy, the bf16x3 algorithm
compiling there) run in chip_smoke.py."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.fft

from dctz_tpu import backend
from dctz_tpu.config import CodecConfig
from dctz_tpu.core import transform
from dctz_tpu.utils import cache


@pytest.mark.parametrize("ids_codec", ["auto", "deflate", "rans", "device"])
@pytest.mark.parametrize("container", ["v1", "v2"])
def test_device_ids_policy(container, ids_codec):
    """Only an explicit ids_codec="device" on a v2 container codes the id
    stream on the device; "auto" keeps the host coder on every backend."""
    cfg = CodecConfig(container=container, ids_codec=ids_codec)
    assert backend.device_ids(cfg) == (
        container == "v2" and ids_codec == "device"
    )


def test_dct_precision_mapping():
    assert backend.dct_precision("highest") == jax.lax.Precision.HIGHEST
    assert (
        backend.dct_precision("high")
        == jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3
    )
    with pytest.raises(KeyError):
        backend.dct_precision("bf16")


def test_platform_and_accelerator_gate():
    """The tests run on the CPU backend; the gate that measurement scripts
    call refuses it instead of falling back."""
    with pytest.raises(RuntimeError, match="no accelerator"):
        backend.require_accelerator()


@pytest.mark.parametrize("name", ["highest", "high"])
def test_dct_precision_compiles_in_the_encode(name):
    """Both mappings trace and run inside the jitted DCT."""
    x = jnp.asarray(np.random.default_rng(0).standard_normal((32, 64)))
    got = jax.jit(
        lambda b: transform.block_dct(b, precision=backend.dct_precision(name))
    )(x)
    assert got.shape == (32, 64) and bool(jnp.isfinite(got).all())


def test_compile_cache_dir_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert cache.compile_cache_dir() == str(tmp_path / "c")


def test_compile_cache_dir_defaults_to_repo(monkeypatch):
    """Unset (or empty), the cache lives at the fixed <repo>/.jax_cache —
    never a temporary, per-process or per-run path."""
    repo = pathlib.Path(__file__).resolve().parents[1]
    for value in (None, ""):
        if value is None:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        else:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", value)
        assert cache.compile_cache_dir() == str(repo / ".jax_cache")
    assert (repo / ".gitignore").read_text().count(".jax_cache/") == 1


def test_enable_compile_cache_sets_jax_config(monkeypatch, tmp_path):
    old = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert cache.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("bs", [8, 16, 32, 64, 128])
def test_float32_dct_matches_scipy(bs, flat):
    """The narrow (nblk, bs) @ (bs, bs) DCT in float32 at HIGHEST against
    SciPy in float64: within 1e-5 * max|x| (float32 accumulation over bs
    terms is ~bs * 2**-24 relative; single-pass bf16 or TF32 would miss it
    by two orders of magnitude). The inverse is held to the same limit."""
    rng = np.random.default_rng(bs)
    x = (rng.standard_normal((256, bs)) * 100).astype(np.float32)
    ref = scipy.fft.dct(x.astype(np.float64), norm="ortho", axis=-1)
    if flat:
        got = transform.block_dct_flat(jnp.asarray(x.reshape(-1)), bs)
        back = transform.block_idct_flat(jnp.asarray(ref, jnp.float32))
        back = np.asarray(back).reshape(-1, bs)
    else:
        got = transform.block_dct(jnp.asarray(x))
        back = np.asarray(transform.block_idct(jnp.asarray(ref, jnp.float32)))
    assert np.asarray(got).dtype == np.float32
    limit = 1e-5 * np.abs(x).max()
    assert np.abs(np.asarray(got, np.float64) - ref).max() <= limit
    assert np.abs(back.astype(np.float64) - x).max() <= limit

