"""Backend policy (ops/backend) and where the CLI puts JAX's persistent
compilation cache."""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from opticalimageprocessor_tpu import cli
from opticalimageprocessor_tpu.ops import backend


def test_cpu_takes_the_plain_float32_path():
    paths = backend.stage_paths("cpu")
    assert paths["band_contraction"] == "float32"
    assert set(paths.values()) <= {"xla", "jnp.fft", "float32"}
    assert backend.band_dot_dtype("cpu") == np.float32


def test_gpu_contracts_in_bfloat16():
    assert backend.stage_paths("gpu").keys() == backend.stage_paths("cpu").keys()
    assert backend.stage_paths("gpu")["registration_fft"] == "jnp.fft"
    assert backend.band_dot_dtype("gpu") == jnp.bfloat16


@pytest.mark.parametrize("platform", ["rocm", "metal", "neuron", ""])
def test_unknown_platform_raises(platform):
    with pytest.raises(RuntimeError, match="no device path"):
        backend.stage_paths(platform or "none")


def test_default_platform_is_jax_default_backend():
    assert backend.stage_paths() == backend.stage_paths(jax.default_backend())
    assert backend.platform_of() == jax.default_backend()


def test_platform_of_devices():
    devs = [SimpleNamespace(platform="gpu") for _ in range(4)]
    assert backend.platform_of(devs) == "gpu"
    assert backend.platform_of(jax.devices()) == "cpu"
    with pytest.raises(ValueError, match="several platforms"):
        backend.platform_of(devs + [SimpleNamespace(platform="cpu")])


def test_stage_paths_returns_a_copy():
    backend.stage_paths("cpu")["band_contraction"] = "changed"
    assert backend.stage_paths("cpu")["band_contraction"] == "float32"


def test_policy_dtypes_are_hashable_jit_statics():
    """The contraction dtype is a static argument of the jitted peak."""
    for platform in backend.STAGE_PATHS:
        hash(backend.band_dot_dtype(platform))


def test_compile_cache_left_to_jax_when_env_set(monkeypatch, tmp_path):
    monkeypatch.setenv(cli.CACHE_ENV, str(tmp_path))
    assert cli.compile_cache_dir() is None
    before = jax.config.jax_compilation_cache_dir
    cli._enable_compile_cache()
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_in_checkout_when_env_unset(monkeypatch):
    monkeypatch.delenv(cli.CACHE_ENV, raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cli.compile_cache_dir() == os.path.join(repo, ".jax_cache")
    # a fixed path: the same on every call
    assert cli.compile_cache_dir() == cli.compile_cache_dir()


def test_register_fast_default_follows_policy(rng):
    """On the CPU the policy picks the float32 contraction: the default
    call equals an explicit float32 call bit for bit."""
    from opticalimageprocessor_tpu.models.device_pipeline import register_fast
    from opticalimageprocessor_tpu.ops import resample

    scene = rng.integers(2000, 42000, (256, 384)).astype(np.uint16)
    pan = np.clip(
        np.rint(np.asarray(resample.upsample4_f32(scene.astype(np.float32)))),
        0, 65535,
    ).astype(np.uint16)
    mss = np.stack([np.roll(scene, b - 1, 1) for b in range(4)])
    kw = dict(slices=4, n_sections=1, win=(16, 16))
    c_def, _ = register_fast(jnp.asarray(pan), jnp.asarray(mss), **kw)
    c_plain, _ = register_fast(
        jnp.asarray(pan), jnp.asarray(mss), dot_dtype=jnp.float32, **kw
    )
    for b in range(4):
        for k in range(2):
            np.testing.assert_array_equal(
                np.asarray(c_def[b][k]), np.asarray(c_plain[b][k])
            )
