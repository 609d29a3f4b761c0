"""Per-layer remat (`EncoderConfig.remat`, `models/encoder.py::remat_layer`):
at dropout 0.1 on the CPU train steps with remat give the losses, every
gradient and the updated weights of the steps without remat, bit for bit
(the recompute draws from a fork of the layer's streams, which leaves the
step's own streams where they were); at dropout 0 the
port's remat=True train steps follow the JAX package's remat=True steps
(`nn.remat` of each layer) as the plain steps do."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from multimodal_sequencing_tpu.data import datasets as jds
from multimodal_sequencing_tpu.models.sequencer import (
    SequencingModel as JSequencingModel)
from multimodal_sequencing_tpu.train.state import (
    make_optimizer as j_make_optimizer, make_train_state)
from multimodal_sequencing_tpu.train.steps import (
    device_batch as j_device_batch, make_train_step)
from multimodal_sequencing_tpu_torch.data.datasets import data_loader
from multimodal_sequencing_tpu_torch.models.convert import params_from_jax
from multimodal_sequencing_tpu_torch.models.encoder import DropoutRng
from multimodal_sequencing_tpu_torch.models.sequencer import (
    SequencingModel, init_weights)
from multimodal_sequencing_tpu_torch.train.state import AdamW
from multimodal_sequencing_tpu_torch.train.steps import train_step

from test_torch_train import BATCH, _datasets, _tiny_cfgs  # noqa: E402

torch.set_num_threads(1)


def _with(cfg, **enc):
    return dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder,
                                                                **enc))


def _step(cfg, batch, steps=2):
    """`steps` train steps of a fresh model on `batch`: the losses and grad
    norms, the last step's gradients and the final weights."""
    model = init_weights(SequencingModel(cfg), 0).train()
    opt = AdamW(model, learning_rate=1e-3, warmup_steps=0, total_steps=10)
    hist = []
    for i in range(steps):
        out = train_step(model, opt, batch, i, 7)
        hist.append((out["loss"], out["grad_norm"]))
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    return hist, grads, model.state_dict()


@pytest.mark.parametrize("mode", ["probs", "folded"])
def test_remat_replays_dropout_bit_equal(wikihow_dir, mode):
    _, tc = _tiny_cfgs()
    tc = _with(tc, hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
               attention_dropout_mode=mode)
    _, tset = _datasets(wikihow_dir)
    batch = next(iter(data_loader(tset, BATCH)))
    plain = _step(_with(tc, remat=False), batch)
    remat = _step(_with(tc, remat=True), batch)
    for (l0, g0), (l1, g1) in zip(plain[0], remat[0]):
        assert torch.equal(l0, l1) and torch.equal(g0, g1)
    assert sorted(plain[1]) == sorted(remat[1])
    assert len(plain[1]) > 30
    for key, g in plain[1].items():
        assert torch.equal(g, remat[1][key]), key
    for key, w in plain[2].items():
        assert torch.equal(w, remat[2][key]), key
    # dropout acted: the step differs from one at dropout 0
    quiet = _step(_with(tc, remat=True, hidden_dropout_prob=0.0,
                        attention_probs_dropout_prob=0.0), batch)
    assert not torch.equal(quiet[0][0][0], plain[0][0][0])


def test_fork_replays_the_streams_and_leaves_the_source():
    rng = DropoutRng(3, 5, "cpu")
    rng.attention_seed()
    copy = rng.fork()
    seeds = [copy.attention_seed() for _ in range(3)]
    masks = torch.rand(8, generator=copy.device)
    # the source did not move, and draws what the copy drew
    assert [rng.attention_seed() for _ in range(3)] == seeds
    assert torch.equal(torch.rand(8, generator=rng.device), masks)


def test_remat_is_a_plain_call_without_grad():
    _, tc = _tiny_cfgs()
    ids = torch.randint(5, 1000, (2, 40),
                        generator=torch.Generator().manual_seed(0))
    ids[:, ::8] = 0
    outs = []
    for remat in (False, True):
        model = init_weights(SequencingModel(_with(tc, remat=remat)), 1)
        model.eval()
        with torch.inference_mode():
            outs.append(model(ids)["heatmap"])
    assert torch.equal(outs[0], outs[1])


def test_remat_steps_follow_jax_remat(wikihow_dir):
    # the JAX package's remat=True step against the port's, at dropout 0,
    # as test_torch_train.py::test_train_steps_follow_jax holds the plain
    # steps: 4 steps from the same weights on the same batches
    jc, tc = _tiny_cfgs()
    jc, tc = _with(jc, remat=True), _with(tc, remat=True)
    jset, _ = _datasets(wikihow_dir)
    batches = [b for epoch in range(2) for b in jds.data_loader(
        jset, BATCH, shuffle=True, seed=0, epoch=epoch)][:4]
    kw = dict(learning_rate=2e-3, warmup_steps=1, total_steps=4,
              weight_decay=0.01, adam_epsilon=1e-8, max_grad_norm=1.0,
              grad_accum_steps=1)
    state = make_train_state(JSequencingModel(jc), jax.random.PRNGKey(0),
                             j_device_batch(batches[0]),
                             tx=j_make_optimizer(**kw))
    model = SequencingModel(tc)
    model.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, state.params), tc))
    opt = AdamW(model, **kw)
    step_fn = make_train_step(jc, donate=False)
    want, got = [], []
    for i, batch in enumerate(batches):
        state, metrics = step_fn(state, j_device_batch(batch),
                                 jax.random.PRNGKey(1))
        want.append((float(metrics["loss"]), float(metrics["grad_norm"])))
        out = train_step(model, opt, batch, i, 0)
        got.append((out["loss"].item(), out["grad_norm"].item()))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=0)
    assert len({round(x, 4) for x, _ in want}) > 2  # the weights moved
