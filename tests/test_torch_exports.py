"""The port's package-level names against the JAX package's.

Every name in the __all__ of awm_tpu and of its subpackages dsp, utils,
data, models, ops and parallel is importable from the port's counterpart,
except two named here: parallel.batch_sharding and parallel.replicated,
which build jax.sharding objects and have no counterpart on a process
group.  frame is held against the JAX frame, __version__ against the JAX
package's."""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import awm_tpu

# JAX-only plumbing: NamedSharding builders for a jax Mesh.
EXEMPT = {"parallel": {"batch_sharding", "replicated"}}
PACKAGES = ["", "dsp", "utils", "data", "models", "ops", "parallel"]


@pytest.mark.parametrize("sub", PACKAGES, ids=lambda s: s or "awm_tpu")
def test_port_exports_every_jax_name(sub):
    jax_pkg = importlib.import_module("awm_tpu" + (f".{sub}" if sub else ""))
    port_pkg = importlib.import_module("awm_tpu_torch" + (f".{sub}" if sub else ""))
    exempt = EXEMPT.get(sub, set())
    assert exempt <= set(jax_pkg.__all__)  # an exemption names a real JAX export
    missing = [n for n in jax_pkg.__all__ if n not in exempt and not hasattr(port_pkg, n)]
    assert not missing, f"awm_tpu_torch.{sub} lacks {missing}"
    unlisted = [n for n in jax_pkg.__all__ if n not in exempt and n not in port_pkg.__all__]
    assert not unlisted, f"awm_tpu_torch.{sub}.__all__ lacks {unlisted}"
    for name in port_pkg.__all__:
        assert hasattr(port_pkg, name), name


def test_package_level_imports():
    """The imports the JAX package's users write, against the port."""
    from awm_tpu_torch import PRESETS, Config, __version__, get_config
    from awm_tpu_torch.dsp import frame, log_mel, nsim_quality, stft
    from awm_tpu_torch.utils import load_mono_16k

    assert __version__ == awm_tpu.__version__ == "0.1.0"
    assert isinstance(get_config("base"), Config) and set(PRESETS) == set(awm_tpu.PRESETS)
    assert all(callable(f) for f in (frame, log_mel, nsim_quality, stft, load_mono_16k))
    # the submodule stays reachable by its full name
    assert importlib.import_module("awm_tpu_torch.dsp.stft").stft is stft


@pytest.mark.parametrize("t,length,hop", [(800, 512, 128), (16000, 400, 160), (512, 512, 1), (10, 3, 4)])
def test_frame_matches_jax(t, length, hop):
    """frame: (..., T) -> (..., 1 + (T - L) // hop, L), the same values as
    the JAX gather, exactly."""
    from awm_tpu.dsp.stft import frame as jframe

    from awm_tpu_torch.dsp import frame

    x = np.random.default_rng(t + length).standard_normal((2, 3, t)).astype(np.float32)
    ref = np.asarray(jframe(jnp.asarray(x), length, hop))
    out = frame(torch.from_numpy(x), length, hop)
    assert tuple(out.shape) == ref.shape == (2, 3, 1 + (t - length) // hop, length)
    np.testing.assert_array_equal(out.numpy(), ref)
