"""The port's functional ensemble-training API (ns_tpu_torch.train.ensemble:
init_ensemble, raw_ensemble_step, make_ensemble_train_step,
train_ensemble) against the JAX package's and against EnsembleTrainer.

  - tests/test_runtime.py:48: an ensemble of 4 BasisGRU members, 25
    iterations; every member's loss falls, members differ;
  - the JAX parity (BasisODE): the JAX init_ensemble's parameters carried
    across, one step of each package's raw_ensemble_step under Adam in
    float64: losses and parameters within 1e-10;
  - EnsembleTrainer's single step (the same members, its objective and
    its Adam) equals one step of raw_ensemble_step;
  - a world-1 'ensemble' mesh (no process group) keeps every member.
"""

import functools

import numpy as np
import pytest
import torch

from ns_tpu_torch.models.basis import BasisGRU, BasisODE
from ns_tpu_torch.parallel import make_mesh
from ns_tpu_torch.train import ensemble as tens
from ns_tpu_torch.train.checkpoint import _flatten_with_paths
from ns_tpu_torch.train.optim import adam


def obs_of(nt=6, n=8, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.normal(size=(nt, 1, 3, n, n)) * 0.1,
                        dtype=dtype)


def test_train_ensemble_reduces_all_losses():
    obs = obs_of()
    model = functools.partial(BasisGRU, 2, 8, 8)
    params, hist = tens.train_ensemble(model, obs, 6, n_models=4,
                                       n_iters=25, device="cpu")
    assert hist.shape == (25, 4)
    assert bool((hist[-1] < hist[0]).all())
    # the members are different draws of the one generator
    basis = params["basis"].numpy()
    assert not np.allclose(basis[0], basis[1])


def test_one_step_matches_jax_float64():
    """BasisODE: its RK4 integration is recomputed in the backward pass
    (odeint_checkpoint), so each member's tensors must be the model's own
    through forward and backward."""
    import jax
    import jax.numpy as jnp
    import optax
    from ns_tpu.models.basis import BasisODE as JODE
    from ns_tpu.train import ensemble as jens
    nt, n, K, n_models = 4, 8, 2, 3
    obs = obs_of(nt, n, torch.float64, seed=1)
    jmodel = JODE(K, n, n)
    # the JAX draws (jitted: eager vmap of init takes seconds), all in
    # float64 (its dense layers draw float32)
    jparams = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float64),
        jax.jit(lambda: jens.init_ensemble(jmodel, n_models, seed=7))())
    tx = optax.adam(1e-3)
    jopt = jax.vmap(tx.init)(jparams)
    jstep = jax.jit(jens.raw_ensemble_step(jmodel, tx, jnp.asarray(
        obs.numpy()), nt))
    jparams1, _, jlosses = jstep(jparams, jopt)

    params = {k: torch.tensor(np.asarray(v)) for k, v in
              _flatten_with_paths(jparams).items()}
    builder = functools.partial(BasisODE, K, n, n, dtype=torch.float64)
    assert set(params) == set(tens.init_ensemble(builder, 1,
                                                 device="cpu"))
    opt = tens.init_opt_state(adam(1e-3), params)
    step = tens.raw_ensemble_step(builder, adam(1e-3), obs, nt)
    params1, _, losses = step(params, opt)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=0, atol=1e-10)
    for k, v in _flatten_with_paths(jparams1).items():
        np.testing.assert_allclose(params1[k].numpy(), np.asarray(v),
                                   rtol=0, atol=1e-10, err_msg=k)


def test_matches_ensemble_trainer_single_step(tmp_path):
    """One raw_ensemble_step from EnsembleTrainer's members, with its
    objective, equals its train_chunk(1)."""
    from ns_tpu_torch.train.trainer import TrainConfig
    rng = np.random.default_rng(2)
    u, v = rng.normal(size=(2, 6, 8, 8)) * 0.1
    npz = str(tmp_path / "d.npz")
    np.savez(npz, u=u, v=v, p=u * v)
    cfg = TrainConfig(model="basis_gru", npz_path=npz, n_coeffs=2,
                      n_frames=6, n_iters=1, out_dir=str(tmp_path / "o"))
    tr = tens.EnsembleTrainer(cfg, 2, device="cpu")
    params = {k: v.detach().clone()
              for k, v in tr._state()["params"].items()}
    opt = tens.init_opt_state(cfg, params)
    step = tens.raw_ensemble_step(
        functools.partial(BasisGRU, 2, 8, 8), cfg, tr.obs, tr.nt,
        forward=lambda model, frames: tr._forward(model))
    _, _, losses = step(params, opt)
    want = tr.train_chunk(1)[0]
    torch.testing.assert_close(losses, want, rtol=0, atol=0)
    for k, v in tr._state()["params"].items():
        torch.testing.assert_close(params[k], v, rtol=0, atol=0)
    # the default objective is the basis families' whole-trajectory one
    params0 = {k: v.detach().clone()
               for k, v in tens.init_ensemble(
                   functools.partial(BasisGRU, 2, 8, 8), 2,
                   seed=cfg.seed, device="cpu").items()}
    default = tens.raw_ensemble_step(functools.partial(BasisGRU, 2, 8, 8),
                                     cfg, tr.obs, tr.nt)
    _, _, losses0 = default(params0, tens.init_opt_state(cfg, params0))
    torch.testing.assert_close(losses0, want, rtol=0, atol=0)


def test_mesh_of_one_rank_keeps_every_member():
    obs = obs_of(4)
    model = functools.partial(BasisGRU, 2, 8, 8)
    mesh = make_mesh({"ensemble": 1}, device_type="cpu")
    step, shard_tree = tens.make_ensemble_train_step(model, adam(1e-3), obs,
                                                     4, mesh)
    params = tens.init_ensemble(model, 3, device="cpu")
    assert shard_tree(params)["basis"].shape[0] == 3
    p_m, h_m = tens.train_ensemble(model, obs, 4, 3, 2, mesh=mesh)
    p_1, h_1 = tens.train_ensemble(model, obs, 4, 3, 2, device="cpu")
    torch.testing.assert_close(h_m, h_1, rtol=0, atol=0)
    torch.testing.assert_close(p_m["basis"], p_1["basis"], rtol=0, atol=0)


def test_builder_not_module():
    with pytest.raises(TypeError, match="builder"):
        tens.init_ensemble(BasisGRU(2, 8, 8), 2, device="cpu")
