"""The port's optimizer (`train/state.py::AdamW`) against the JAX package's
`make_optimizer` (optax clip + adamw with bf16 first moment, decay mask,
warmup/decay schedule, MultiSteps) on a small tree fed the same gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from multimodal_sequencing_tpu.train.state import (
    linear_warmup_decay as j_schedule, make_optimizer as j_make_optimizer)
from multimodal_sequencing_tpu_torch.models.encoder import Dense, Embed, LayerNorm
from multimodal_sequencing_tpu_torch.train.state import (
    AdamW, linear_warmup_decay)

torch.set_num_threads(1)

# f32 on both sides; XLA fuses the moment updates into FMAs and rounds the
# clip factor once where the port rounds twice, so parameters may differ by
# a few f32 ulps per step of lr-sized updates
ATOL, RTOL = 2e-7, 1e-6


class Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.dense = Dense(6, 4)
        self.emb = Embed(10, 4)
        self.ln = LayerNorm(4)


def _trees(seed=0):
    rng = np.random.RandomState(seed)
    params = {"dense": {"kernel": rng.randn(6, 4).astype(np.float32),
                        "bias": rng.randn(4).astype(np.float32)},
              "emb": {"embedding": rng.randn(10, 4).astype(np.float32)},
              "ln": {"scale": rng.randn(4).astype(np.float32),
                     "bias": rng.randn(4).astype(np.float32)}}
    model = Tiny()
    with torch.no_grad():
        model.dense.weight.copy_(torch.from_numpy(params["dense"]["kernel"].T))
        model.dense.bias.copy_(torch.from_numpy(params["dense"]["bias"]))
        model.emb.weight.copy_(torch.from_numpy(params["emb"]["embedding"]))
        model.ln.weight.copy_(torch.from_numpy(params["ln"]["scale"]))
        model.ln.bias.copy_(torch.from_numpy(params["ln"]["bias"]))
    return params, model


def _port_leaves(model):
    return {"dense": {"kernel": model.dense.weight.detach().numpy().T,
                      "bias": model.dense.bias.detach().numpy()},
            "emb": {"embedding": model.emb.weight.detach().numpy()},
            "ln": {"scale": model.ln.weight.detach().numpy(),
                   "bias": model.ln.bias.detach().numpy()}}


def _port_grads(g):
    # the port's parameter order: dense.weight, dense.bias, emb.weight,
    # ln.weight, ln.bias
    return [torch.from_numpy(np.ascontiguousarray(g["dense"]["kernel"].T)),
            torch.from_numpy(g["dense"]["bias"]),
            torch.from_numpy(g["emb"]["embedding"]),
            torch.from_numpy(g["ln"]["scale"]), torch.from_numpy(g["ln"]["bias"])]


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_follows_optax(accum, weight_decay):
    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=6,
              weight_decay=weight_decay, adam_epsilon=1e-8, max_grad_norm=1.0,
              grad_accum_steps=accum)
    params, model = _trees()
    tx = j_make_optimizer(**kw)
    jparams = jax.tree.map(jnp.asarray, params)
    state = tx.init(jparams)
    update = jax.jit(tx.update)  # as inside the jitted JAX train step
    opt = AdamW(model, **kw)
    rng = np.random.RandomState(1)
    clipped = 0
    for step in range(5 * accum):
        # alternate large (clipped) and small (unclipped) gradients
        scale = 3.0 if step % 2 == 0 else 0.05
        g = jax.tree.map(lambda x: (rng.randn(*x.shape) * scale).astype(
            np.float32), params)
        clipped += float(optax_global_norm(g)) >= 1.0
        updates, state = update(jax.tree.map(jnp.asarray, g), state, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        # step reports the global norm of the micro-step's gradients
        assert float(opt.step(_port_grads(g))) == pytest.approx(
            optax_global_norm(g), rel=1e-6)
        got = _port_leaves(model)
        for path in (("dense", "kernel"), ("dense", "bias"),
                     ("emb", "embedding"), ("ln", "scale"), ("ln", "bias")):
            np.testing.assert_allclose(
                got[path[0]][path[1]], np.asarray(jparams[path[0]][path[1]]),
                atol=ATOL, rtol=RTOL, err_msg=f"step {step} {path}")
    assert clipped >= 2
    assert opt.count == 5 and opt.mini_step == 0
    assert opt.mu[0].dtype == torch.bfloat16 and opt.nu[0].dtype == torch.float32
    # the parameters moved: the schedule's first update is 0, the rest not
    assert not np.allclose(_port_leaves(model)["dense"]["kernel"],
                           params["dense"]["kernel"])


def optax_global_norm(tree):
    return np.sqrt(sum(float(np.sum(np.square(x)))
                       for x in jax.tree.leaves(tree)))


@pytest.mark.parametrize("warmup,total", [(0, 10), (3, 10), (4, 4)])
def test_schedule_matches_optax_join(warmup, total):
    want = j_schedule(2e-5, warmup, total)
    got = linear_warmup_decay(2e-5, warmup, total)
    for count in range(total + 3):
        assert got(count) == pytest.approx(float(want(count)), rel=1e-6,
                                           abs=1e-12)
    assert got(0) == 0.0


def test_decay_mask_by_module_type():
    _, model = _trees()
    opt = AdamW(model)
    decays = {id(p) for p in opt.decay}
    assert [n for n, p in zip(opt.names, opt.params) if id(p) in decays] == [
        "dense.weight", "emb.weight"]


def test_optimizer_state_round_trip():
    params, model = _trees()
    opt = AdamW(model, learning_rate=1e-2, warmup_steps=1, total_steps=4,
                grad_accum_steps=2)
    rng = np.random.RandomState(0)
    for _ in range(3):
        opt.step(_port_grads(jax.tree.map(
            lambda x: rng.randn(*x.shape).astype(np.float32), params)))
    _, model2 = _trees()
    opt2 = AdamW(model2, learning_rate=1e-2, warmup_steps=1, total_steps=4,
                 grad_accum_steps=2)
    opt2.load_state_dict(opt.state_dict())
    assert (opt2.count, opt2.mini_step) == (1, 1)
    for a, b in zip(opt.mu + opt.nu + opt.acc, opt2.mu + opt2.nu + opt2.acc):
        assert torch.equal(a, b)
