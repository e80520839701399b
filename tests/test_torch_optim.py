"""The port's optimizer (ns_tpu_torch.train.optim) against the JAX
package's make_optimizer and optax, on the CPU.

Tolerances: the schedules equal optax's values exactly, at every count
from 0 to horizon + 2 (optax evaluated op by op, as `tx.update` runs
outside jit: under jit XLA may fuse the schedule's float32 multiply-add
into an FMA and evaluate the cosine by another formula, an ulp apart);
Adam, with and without warm-up, cosine decay and clipping, against
`make_optimizer(cfg).update` + `optax.apply_updates` on random float64
trees over 5 steps, <= 1e-12 relative to each leaf's max. The state's key
paths equal those of the JAX package's checkpoint for the same config.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ns_tpu.train import checkpoint as jck
from ns_tpu.train.trainer import TrainConfig as JaxConfig
from ns_tpu.train.trainer import make_optimizer
from ns_tpu_torch.train import checkpoint as tck
from ns_tpu_torch.train import optim
from ns_tpu_torch.train.trainer import TrainConfig

SHAPES = {"lift/w": (3, 4), "lift/b": (4,), "spectral/0/lo_re": (2, 5),
          "spectral/10/lo_re": (2, 3), "spectral/2/hi_im": (2, 3)}
CONFIGS = [dict(), dict(warmup_iters=2, n_iters=6),
           dict(lr_schedule="cosine", n_iters=4),
           dict(lr_schedule="cosine", warmup_iters=2, n_iters=5,
                grad_clip=0.5),
           dict(lr_schedule="cosine", schedule_horizon=9, n_iters=3),
           dict(grad_clip=100.0)]


def nest(flat):
    out = {}
    for k, v in flat.items():
        *head, last = k.split("/")
        d = out
        for h in head:
            d = d.setdefault(h, {})
        d[last] = v
    return out


@pytest.mark.parametrize("lr,warmup,horizon",
                         [(1e-3, 1, 1), (1e-3, 7, 8), (3e-4, 10, 43),
                          (0.7, 3, 1000), (1e-2, 33, 110)])
def test_schedules_match_optax(lr, warmup, horizon):
    pairs = [(optax.linear_schedule(0.0, lr, warmup),
              optim.linear_schedule(0.0, lr, warmup)),
             (optax.cosine_decay_schedule(lr, horizon),
              optim.cosine_decay_schedule(lr, horizon)),
             (optax.warmup_cosine_decay_schedule(
                 init_value=0.0, peak_value=lr, warmup_steps=warmup,
                 decay_steps=warmup + horizon),
              optim.warmup_cosine_decay_schedule(0.0, lr, warmup,
                                                 warmup + horizon))]
    for want_fn, got_fn in pairs:
        for c in range(warmup + horizon + 3):
            want = float(want_fn(jnp.asarray(c, jnp.int32)))
            assert got_fn(c) == want, (c, got_fn(c), want)


@pytest.mark.parametrize("kw", CONFIGS)
def test_make_schedule_matches_make_optimizer(kw):
    """make_schedule's arguments are make_optimizer's: the lr each update
    applies, read off a zero-moment probe (update = -lr * g / (|g| + eps)
    with g = 1 and clipping far away)."""
    kw = {**kw, "lr": 1e-2, "grad_clip": 0.0}
    cfg = JaxConfig(**kw)
    tx, sched = make_optimizer(cfg), optim.make_schedule(TrainConfig(**kw))
    p = {"w": jnp.zeros(1)}
    st = tx.init(p)
    for c in range(cfg.n_iters + 3):
        u, st = tx.update({"w": jnp.ones(1)}, st, p)
        lr = kw["lr"] if sched is None else sched(c)
        np.testing.assert_allclose(float(u["w"][0]), -lr / (1 + 1e-8),
                                   rtol=1e-12, atol=0)


@pytest.mark.parametrize("kw", CONFIGS)
def test_adam_matches_optax(kw):
    rng = np.random.default_rng(0)
    cfg = dict(lr=1e-2, **kw)
    tx = make_optimizer(JaxConfig(**cfg))
    p0 = {k: rng.normal(size=s) for k, s in SHAPES.items()}
    jp = nest({k: jnp.asarray(v) for k, v in p0.items()})
    state = tx.init(jp)
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    opt = optim.Adam(TrainConfig(**cfg), tp)
    for _ in range(5):
        g = {k: 3.0 * rng.normal(size=s) for k, s in SHAPES.items()}
        u, state = tx.update(nest({k: jnp.asarray(v) for k, v in g.items()}),
                             state, jp)
        jp = optax.apply_updates(jp, u)
        opt.step({k: torch.tensor(v) for k, v in g.items()})
        want = jck._flatten_with_paths(jp)
        for k in SHAPES:
            np.testing.assert_allclose(
                tp[k].numpy(), want[k], rtol=0,
                atol=1e-12 * np.abs(want[k]).max())
    # the state too, by optax's key paths
    got = tck._flatten_with_paths(opt.state_tree())
    want = jck._flatten_with_paths(state)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(tck._host(got[k]), v, rtol=0,
                                   atol=1e-12 * max(np.abs(v).max(), 1))


@pytest.mark.parametrize("kw", [dict(), dict(warmup_iters=2),
                                dict(lr_schedule="cosine"),
                                dict(lr_schedule="cosine", grad_clip=1.0),
                                dict(grad_clip=1.0)])
def test_state_key_paths_match_jax_checkpoint(tmp_path, kw):
    """The port's checkpoint of {"params", "opt_state"} has the JAX
    checkpoint's leaves: names, shapes and dtypes (float32 params, int32
    counts), and loads back into the optimizer."""
    params = {k: np.zeros(s, np.float32) for k, s in SHAPES.items()}
    with jax.enable_x64(False):
        st = make_optimizer(JaxConfig(**kw)).init(nest(params))
        want = jck.save_checkpoint({"params": nest(params), "opt_state": st},
                                   str(tmp_path / "jax"))
    tp = {k: torch.tensor(v) for k, v in params.items()}
    opt = optim.Adam(TrainConfig(**kw), tp)
    opt.step({k: torch.ones_like(v) for k, v in tp.items()})
    got = tck.save_checkpoint({"params": tp, "opt_state": opt.state_tree()},
                              str(tmp_path / "torch"))
    with np.load(want) as a, np.load(got) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert (a[k].shape, a[k].dtype) == (b[k].shape, b[k].dtype), k
    fresh = optim.Adam(TrainConfig(**kw),
                       {k: torch.zeros_like(v) for k, v in tp.items()})
    like = {"params": tp, "opt_state": fresh.state_tree()}
    fresh.load_state_tree(tck.load_checkpoint(want, like)["opt_state"])
    assert fresh.count == 0
    fresh.load_state_tree(tck.load_checkpoint(got, like)["opt_state"])
    assert fresh.count == 1
    assert fresh.schedule_count == (1 if fresh.schedule else 0)


def test_clip_scales_above_the_threshold_only():
    """Clipping scales the gradient by c / |g| above the threshold and
    leaves it as it is below: the first moment after one step is
    (1 - b1) times the clipped gradient."""
    g = {"a": torch.tensor([3.0, 4.0], dtype=torch.float64)}
    for clip, want in ((1.0, [0.6, 0.8]), (10.0, [3.0, 4.0])):
        cfg = dataclasses.replace(TrainConfig(), grad_clip=clip)
        opt = optim.Adam(cfg, {"a": torch.zeros(2, dtype=torch.float64)})
        opt.step(g)
        np.testing.assert_allclose(opt.mu[0].numpy(),
                                   (1 - optim.B1) * np.array(want),
                                   rtol=1e-15)
