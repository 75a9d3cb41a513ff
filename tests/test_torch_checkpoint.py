"""Sampler checkpoints of mellon_tpu_torch (``parallel.checkpoint``)
against mellon_tpu's format: the round trip of tests/test_mcmc.py's
test_checkpoint_roundtrip, the torch.Generator state, a run resumed from
a loaded checkpoint, and the refusal of a JAX PRNG key in either
direction."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU64, clustered, to_np
import mellon_tpu_torch as mt
from mellon_tpu.parallel import load_sampler_state as jax_load
from mellon_tpu.parallel import save_sampler_state as jax_save
from mellon_tpu.parallel.checkpoint import FORMAT_VERSION as jax_format_version
from mellon_tpu_torch.inference import mcmc
from mellon_tpu_torch.inference.samplers import HMCState
from mellon_tpu_torch.parallel import FORMAT_VERSION, load_sampler_state, save_sampler_state


def test_checkpoint_roundtrip(tmp_path):
    """tests/test_mcmc.py's round trip in the port: an HMCState, the step
    size, the mass and metadata; the base name and the .npz name address
    the same checkpoint, sidecar included."""
    state = HMCState(torch.arange(4.0), torch.tensor(1.5), torch.tensor([0.1, 0.2, 0.3, 0.4]))
    path = str(tmp_path / "ckpt.npz")
    save_sampler_state(path, state=state, step_size=torch.tensor(0.3),
                       inv_mass_diag=torch.ones(4), metadata={"algorithm": "nuts"})
    loaded = load_sampler_state(path, state_template=state)
    assert type(loaded["state"]) is HMCState
    np.testing.assert_allclose(to_np(loaded["state"].z), np.arange(4.0))
    assert float(loaded["step_size"]) == pytest.approx(0.3)
    assert loaded["metadata"] == {"format_version": FORMAT_VERSION, "device": "cpu",
                                  "algorithm": "nuts"}
    loaded2 = load_sampler_state(str(tmp_path / "ckpt"), state_template=state)
    assert loaded2["metadata"]["algorithm"] == "nuts"
    np.testing.assert_allclose(to_np(loaded2["inv_mass_diag"]), np.ones(4))
    assert load_sampler_state(path)["state"][2].shape == (4,)


def test_format_matches_jax(tmp_path):
    """The same file layout as the JAX package's: mellon_tpu reads the
    port's arrays, state and sidecar, and the port reads a mellon_tpu
    checkpoint that holds no key; equal values (exactly)."""
    state = HMCState(torch.arange(3.0, dtype=torch.float64), torch.tensor(2.0, dtype=torch.float64),
                     torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64))
    samples = torch.tensor(np.random.RandomState(0).randn(2, 5, 3))
    save_sampler_state(tmp_path / "port", samples=samples, state=state,
                       step_size=torch.tensor(0.25, dtype=torch.float64), metadata={"k": 1})
    back = jax_load(str(tmp_path / "port"))
    np.testing.assert_array_equal(np.asarray(back["samples"]), to_np(samples))
    np.testing.assert_array_equal(np.asarray(back["state"][0]), np.arange(3.0))
    assert back["metadata"]["k"] == 1 and "rng_key" not in back

    jax_save(str(tmp_path / "jax"), samples=jnp.asarray(to_np(samples)),
             inv_mass_diag=jnp.ones(3), metadata={"algorithm": "hmc"})
    loaded = load_sampler_state(tmp_path / "jax.npz", device="cpu")
    np.testing.assert_array_equal(to_np(loaded["samples"]), to_np(samples))
    assert loaded["metadata"]["algorithm"] == "hmc"


def test_legacy_sidecar_next_to_the_npz_name(tmp_path):
    """A sidecar at '<path>.json' (written before path normalization) is
    found when '<base>.json' is missing."""
    path = tmp_path / "old.npz"
    save_sampler_state(path, step_size=torch.tensor(0.5), metadata={"algorithm": "nuts"})
    (tmp_path / "old.json").rename(tmp_path / "old.npz.json")
    assert load_sampler_state(path)["metadata"]["algorithm"] == "nuts"


def test_tensors_load_on_the_device_they_were_saved_from(tmp_path, monkeypatch):
    """With no ``device=``, tensors go back to the device the sidecar
    names (the CPU here, whatever config.DEFAULT_DEVICE says), and a
    mellon_tpu checkpoint, whose sidecar names none, loads on
    config.DEFAULT_DEVICE; an explicit ``device=`` wins."""
    monkeypatch.setattr(mt.config, "DEFAULT_DEVICE", "meta")
    save_sampler_state(tmp_path / "p", samples=torch.ones(2, 3), state=(torch.zeros(3),),
                       rng_key=torch.Generator().manual_seed(0))
    assert json.loads((tmp_path / "p.json").read_text())["device"] == "cpu"
    loaded = load_sampler_state(tmp_path / "p")
    assert loaded["samples"].device.type == loaded["state"][0].device.type == "cpu"
    assert loaded["rng_key"].device.type == "cpu"
    jax_save(str(tmp_path / "j"), samples=jnp.ones((2, 3)), inv_mass_diag=jnp.ones(3))
    from_jax = load_sampler_state(tmp_path / "j")
    assert from_jax["samples"].device.type == from_jax["inv_mass_diag"].device.type == "meta"
    assert load_sampler_state(tmp_path / "j", device="cpu")["samples"].device.type == "cpu"


def test_generator_state_round_trip(tmp_path):
    """A torch.Generator's state (uint8 bytes, marked in the sidecar) comes
    back as a generator whose next draws equal the original's."""
    g = torch.Generator().manual_seed(3)
    torch.randn(7, generator=g)
    save_sampler_state(tmp_path / "g", rng_key=g)
    meta = json.loads((tmp_path / "g.json").read_text())
    assert meta["rng"] == {"kind": "torch.Generator", "device": "cpu"}
    assert np.load(tmp_path / "g.npz")["rng_state"].dtype == np.uint8
    loaded = load_sampler_state(tmp_path / "g")["rng_key"]
    assert isinstance(loaded, torch.Generator)
    assert torch.equal(torch.randn(5, generator=loaded), torch.randn(5, generator=g))


def test_a_jax_key_does_not_cross(tmp_path):
    """Saving a JAX key (typed or raw) or a JAX array raises TypeError;
    loading a mellon_tpu checkpoint that holds a key raises ValueError;
    mellon_tpu's loader finds no key in the port's checkpoint."""
    for key in (jax.random.PRNGKey(0), jax.random.key(0)):
        with pytest.raises(TypeError, match="JAX PRNG key"):
            save_sampler_state(tmp_path / "a", rng_key=key)
    with pytest.raises(TypeError, match="JAX array"):
        save_sampler_state(tmp_path / "a", samples=jnp.ones(3))
    for key in (jax.random.PRNGKey(1), jax.random.key(1)):
        jax_save(str(tmp_path / "j"), step_size=jnp.asarray(0.1), rng_key=key)
        with pytest.raises(ValueError, match="JAX PRNG key"):
            load_sampler_state(tmp_path / "j")
    save_sampler_state(tmp_path / "p", step_size=torch.tensor(0.1),
                       rng_key=torch.Generator().manual_seed(0))
    assert "rng_key" not in jax_load(str(tmp_path / "p"))


def test_resume_from_a_loaded_checkpoint_is_exact(tmp_path):
    """A density estimator's NUTS chains, checkpointed with their
    generator: resuming from the loaded checkpoint gives the same draws,
    bit for bit, as resuming from the state in memory."""
    x = clustered(200, 3, seed=90)
    est = mt.DensityEstimator(n_landmarks=20, optimizer="nuts",
                              sampler_options=dict(num_chains=3, num_warmup=15, num_samples=5),
                              **CPU64)
    est.fit(x)
    res = est.mcmc_result
    potential = est._sampler_potential(est.pre_transformation)
    z_last = res.samples[:, -1]
    generator = torch.Generator().manual_seed(11)
    save_sampler_state(tmp_path / "run", samples=res.samples, state=z_last,
                       step_size=res.step_size, inv_mass_diag=res.inv_mass_diag,
                       rng_key=generator)
    loaded = load_sampler_state(tmp_path / "run")
    kw = dict(num_samples=6, max_tree_depth=6)
    memory = mcmc.resume_mcmc(potential, z_last, generator, res.step_size, res.inv_mass_diag, **kw)
    disk = mcmc.resume_mcmc(potential, loaded["state"][0], loaded["rng_key"],
                            loaded["step_size"], loaded["inv_mass_diag"], **kw)
    assert torch.equal(memory.samples, disk.samples)
    assert torch.equal(memory.potential, disk.potential)
    assert torch.equal(loaded["samples"], res.samples)


def test_package_exports_the_checkpoint_functions():
    assert mt.save_sampler_state is save_sampler_state
    assert mt.load_sampler_state is load_sampler_state
    assert jax_format_version == FORMAT_VERSION
