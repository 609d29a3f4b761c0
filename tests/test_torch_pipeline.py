"""GPipe pipeline parallelism through the port (`parallel/pipeline.py`)
against the JAX package's on its virtual mesh and against the port's own
unpipelined step.

* The stage split and its error; the FSDP at-rest plan of a pipelined
  model against JAX `tree_shardings(..., apply_tp=False)`.
* The pipelined forward (2 stages x 2 microbatches, and 4 x 4 at 4
  layers) against JAX `make_pipeline_train_step`'s forward and the
  sequential model (2e-5), for the v0, v1 and p1 heads.
* The pipelined step in one process (every stage held here) against the
  unpipelined one at dropout 0.1: the first step's loss (1e-5 relative)
  and gradients (1e-5 of their global norm), the weights after it, the
  third step's loss (1e-4), for v0, v1, p1 (also with remat) and BERSON.
* BERSON's `trunk_out` loss against JAX's `_det_trunk_out` (1e-6).
* JAX's guards, with its exception types.
* One spawn of four gloo ranks as 2 data x 2 pipeline stages, with and
  without FSDP, against one process at dropout 0.1 (the same limits);
  the FSDP run's checkpoint resumes on its layout and evaluates in one
  process to the run's own eval output.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from multimodal_sequencing_tpu.models.sequencer import (
    SequencingModel as JSequencingModel)
from multimodal_sequencing_tpu.parallel import pipeline as jpipeline
from multimodal_sequencing_tpu.parallel.mesh import make_mesh, shard_batch
from multimodal_sequencing_tpu.train.state import (
    make_optimizer as j_make_optimizer, make_train_state)
from multimodal_sequencing_tpu_torch.models import config as tcfg
from multimodal_sequencing_tpu_torch.models.berson import BersonOrdering
from multimodal_sequencing_tpu_torch.models.convert import params_from_jax
from multimodal_sequencing_tpu_torch.models.sequencer import SequencingModel
from multimodal_sequencing_tpu_torch.parallel import pipeline
from multimodal_sequencing_tpu_torch.parallel.mesh import (
    Layout, data_parallel, Ring)
from multimodal_sequencing_tpu_torch.parallel.sharding_rules import plan
from multimodal_sequencing_tpu_torch.train.checkpoint import (
    restore_checkpoint)
from multimodal_sequencing_tpu_torch.train.steps import device_batch

from test_pipeline import _det_trunk_out, _setup
from test_torch_parallel import (FSDP_MIN, _assert_matches, _berson_case,
                                 _models, _text_case)
from torch_parallel_ranks import run_case, run_ranks

torch.set_num_threads(1)


def _port_cfg(jc):
    """The port's config with the JAX config's fields (the two dataclasses
    have the same fields)."""
    enc = tcfg.EncoderConfig(**dataclasses.asdict(jc.encoder))
    return tcfg.MultimodalConfig(**{
        f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)
        if f.name != "encoder"}, encoder=enc)


# ----- the stage split and the at-rest plan ---------------------------------


def test_stack_layer_params_splits_contiguous_stages():
    enc = {f"layer_{i}": i for i in range(4)}
    stages = pipeline.stack_layer_params(enc, 4, 2)
    assert stages == [[0, 1], [2, 3]]  # stage 1's second layer is layer_3
    model = SequencingModel(tcfg.MultimodalConfig(
        encoder=tcfg.EncoderConfig.tiny(num_hidden_layers=4)))
    stages = pipeline.stack_layer_params(model.encoder, 4, 4)
    assert [s[0] for s in stages] == [model.encoder.layer_0,
                                      model.encoder.layer_1,
                                      model.encoder.layer_2,
                                      model.encoder.layer_3]
    with pytest.raises(ValueError, match="not divisible by pipeline"):
        pipeline.stack_layer_params(enc, 4, 3)


@pytest.mark.parametrize("n_data", [2, 4])
def test_pipelined_fsdp_plan_matches_jax_tree_shardings(wikihow_dir, n_data):
    # the model dim holds stages: FSDP over the data dim alone
    params, model = _models("text", wikihow_dir)
    mesh = make_mesh(n_data, 2)
    from multimodal_sequencing_tpu.parallel.sharding_rules import (
        tree_shardings)
    from multimodal_sequencing_tpu_torch.models.convert import _LEAVES
    want = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(tree_shardings(
            params, mesh, fsdp=True, fsdp_min_elems=FSDP_MIN,
            apply_tp=False))[0]:
        names = [str(getattr(p, "key", p)) for p in path]
        if any(a is not None for a in sh.spec):
            assert "model" not in sh.spec
            want[".".join(names[:-1] + [_LEAVES[names[-1]]])] = True
    got = plan(((n, p.shape) for n, p in model.named_parameters()), n_data,
               1, True, FSDP_MIN)
    assert {n for n, (t, f) in got.items() if f is not None} == set(want)
    assert all(t is None for t, _ in got.values())


# ----- the forward against JAX ----------------------------------------------


def _jax_pair(wikihow_dir, tokenizer, version, n_layers):
    """(JAX cfg, its batch (numpy), its params, the port's model on
    them)."""
    jc, batch, _, _ = _setup(wikihow_dir, tokenizer, n_layers)
    jc = dataclasses.replace(jc, hierarchical_version=version)
    model = JSequencingModel(jc)
    state = make_train_state(
        model, jax.random.PRNGKey(0), batch,
        tx=j_make_optimizer(learning_rate=1e-3, warmup_steps=2,
                            total_steps=50))
    params = jax.tree.map(np.asarray, state.params)
    tc = _port_cfg(jc)
    port = SequencingModel(tc)
    port.load_state_dict(params_from_jax(params, tc))
    return jc, {k: np.asarray(v) for k, v in batch.items()}, params, port


HEAD_OUT = {"v0": "logits", "v1": "heatmap", "p1": "pointer_logits"}


@pytest.mark.parametrize("version,n_stages,n_micro,n_layers", [
    ("v1", 2, 2, 2), ("v1", 4, 4, 4), ("v0", 2, 2, 2), ("p1", 2, 2, 2)])
def test_pipelined_forward_matches_jax_and_sequential(
        wikihow_dir, tokenizer, version, n_stages, n_micro, n_layers):
    jc, batch, params, port = _jax_pair(wikihow_dir, tokenizer, version,
                                        n_layers)
    mesh = make_mesh(n_data=8 // n_stages, n_model=n_stages)
    _, jforward = jpipeline.make_pipeline_train_step(
        jc, mesh, n_stages=n_stages, n_micro=n_micro, donate=False)
    want = jax.jit(lambda p, b: jforward(p, b, jax.random.PRNGKey(3),
                                         deterministic=True))(
        params, shard_batch(batch, mesh))
    _, forward = pipeline.make_pipeline_train_step(
        port.cfg, Ring(n_stages), n_stages, n_micro)
    db = device_batch(batch, "cpu")
    port.eval()
    with torch.no_grad():
        got = forward(port, db, None, deterministic=True)
        seq = port(db["input_ids"], db["attention_mask"],
                   db["token_type_ids"],
                   order_labels=db["labels"] if version == "p1" else None)
    key = HEAD_OUT[version]
    np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got[key].numpy(), seq[key].numpy(),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got["sequence_output"].numpy(),
                               seq["sequence_output"].numpy(), rtol=2e-5,
                               atol=2e-5)


def _jitted_berson_setup(n_layers=2, b=4, n=4):
    """`test_pipeline._berson_setup` with the init jitted (an eager BERSON
    init takes ~20 s on the CPU)."""
    from multimodal_sequencing_tpu.data.packing import StoryPacker
    from multimodal_sequencing_tpu.data.tokenization import (
        SimpleWordTokenizer)
    from multimodal_sequencing_tpu.models.berson import (
        BersonOrdering as JBersonOrdering)
    from multimodal_sequencing_tpu.models.config import (
        EncoderConfig, MultimodalConfig)
    enc = EncoderConfig.tiny(max_position_embeddings=100,
                             num_hidden_layers=n_layers)
    cfg = MultimodalConfig(encoder=enc, max_story_length=n,
                           max_seq_length=64, per_seq_max_length=8)
    tok = SimpleWordTokenizer(vocab_size=enc.vocab_size)
    cfg.cls_id, cfg.pad_id = 0, 1
    packer = StoryPacker(tok, cfg.max_seq_length, cfg.per_seq_max_length)
    rng = np.random.RandomState(7)
    items = [packer.pack_berson_story(
        [f"alpha {k} beta {i} gamma delta" for i in range(n)],
        rng.permutation(n).tolist()) for k in range(b)]
    batch = {k: jax.numpy.asarray(np.stack([it[k] for it in items]))
             for k in items[0]}
    model = JBersonOrdering(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), batch)["params"]
    return cfg, model, params, batch


def test_berson_trunk_out_loss_matches_jax():
    jc, jmodel, params, batch = _jitted_berson_setup()
    mesh = make_mesh(n_data=4, n_model=2)
    lang = jax.jit(lambda p, b: _det_trunk_out(jc, p, b, mesh, n_stages=2,
                                               n_micro=2))(params, batch)
    want = jax.jit(lambda p, b, t: jmodel.apply(
        {"params": p}, b, deterministic=True, trunk_out=t))(params, batch,
                                                           lang)
    tc = _port_cfg(jc)
    port = BersonOrdering(tc)
    port.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                         tc))
    port.eval()
    db = device_batch({k: np.array(v) for k, v in batch.items()}, "cpu")
    b, p, _ = db["input_ids"].shape
    with torch.no_grad():
        x = port.inner.embeddings(db["input_ids"].reshape(b * p, -1),
                                  db["token_type_ids"].reshape(b * p, -1))
        trunk = pipeline.gpipe_layers(
            tc.encoder, pipeline.stack_layer_params(port.inner, 2, 2), x,
            db["attention_mask"].reshape(b * p, -1).int(), None, 2, 2,
            Ring(2))
        got = port(db, deterministic=True, trunk_out=trunk)
        plain = port(db, deterministic=True)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(got["pointer_logits"].numpy(),
                               np.asarray(want["pointer_logits"]), atol=1e-5)
    np.testing.assert_allclose(float(got["loss"]), float(plain["loss"]),
                               rtol=1e-6)


# ----- the step in one process against the unpipelined step ---------------


def _version_case(wikihow_dir, version, p=0.1, layers=2, batch=4):
    case = _text_case(wikihow_dir, batch, p)
    cfg = case["cfg"]
    cfg.hierarchical_version = version
    cfg.encoder.num_hidden_layers = layers
    if version == "v0":
        cfg.num_labels = cfg.max_story_length
        case["batches"] = [dict(b, labels=b["labels"][:, 0])
                           for b in case["batches"]]
    return case


def _one_process_cases(wikihow_dir):
    remat = _version_case(wikihow_dir, "p1")
    remat["cfg"].encoder.remat = True
    return {"v1": (_version_case(wikihow_dir, "v1"), (2, 2)),
            "v1_4x4": (_version_case(wikihow_dir, "v1", layers=4), (4, 4)),
            "v0": (_version_case(wikihow_dir, "v0"), (2, 2)),
            "p1": (_version_case(wikihow_dir, "p1"), (2, 2)),
            "p1_remat": (remat, (2, 2)),
            "berson": (_berson_case(wikihow_dir, 0.1), (2, 2))}


@pytest.fixture(scope="module")
def one_process(wikihow_dir):
    out = {}
    for name, (spec, pipe) in _one_process_cases(wikihow_dir).items():
        out[name] = (run_case(dict(spec, pipeline=pipe)), run_case(spec))
    return out


@pytest.mark.parametrize("case", ["v1", "v1_4x4", "v0", "p1", "p1_remat",
                                  "berson"])
def test_pipelined_step_matches_unpipelined(one_process, case):
    got, want = one_process[case]
    _assert_matches(got, want)


# ----- JAX's guards ---------------------------------------------------------


def test_pipeline_guards_raise_jax_errors():
    enc = tcfg.EncoderConfig.tiny()
    cfg = tcfg.MultimodalConfig(encoder=enc, hierarchical_version="v1")
    with pytest.raises(ValueError, match="pipeline stages 4"):
        pipeline.make_pipeline_train_step(cfg, Ring(2), 4, 2)
    with pytest.raises(NotImplementedError, match="text encoder stack"):
        pipeline.make_pipeline_train_step(
            dataclasses.replace(cfg, multimodal=True), Ring(2), 2, 2)
    with pytest.raises(NotImplementedError, match="hl_include_objectives"):
        pipeline.make_pipeline_train_step(
            dataclasses.replace(cfg, hl_include_objectives=["head"]),
            Ring(2), 2, 2)
    with pytest.raises(NotImplementedError, match="head decode"):
        pipeline.make_pipeline_train_step(
            dataclasses.replace(cfg, hierarchical_version="decode"),
            Ring(2), 2, 2)
    with pytest.raises(NotImplementedError, match="BERSON text trunk"):
        pipeline.make_berson_pipeline_train_step(
            dataclasses.replace(cfg, multimodal=True), Ring(2), 2, 2)
    with pytest.raises(ValueError, match="pipeline stages 2"):
        pipeline.make_berson_pipeline_train_step(cfg, Ring(4), 2, 2)


def test_pipeline_refuses_mutable_state_and_indivisible_batches():
    from multimodal_sequencing_tpu_torch.models.clip_visual import BatchNorm
    from multimodal_sequencing_tpu_torch.train.state import AdamW
    enc = tcfg.EncoderConfig.tiny()
    cfg = tcfg.MultimodalConfig(encoder=enc, hierarchical_version="v1")
    model = SequencingModel(cfg)
    model.stats = BatchNorm(4)
    step, _ = pipeline.make_pipeline_train_step(cfg, Ring(2), 2, 2)
    with pytest.raises(NotImplementedError, match="batch_stats"):
        step(model, AdamW(model), {}, 0, 0)
    layers = pipeline.stack_layer_params(model.encoder, 2, 2)
    x = torch.zeros((6, 8, enc.hidden_size))
    mask = torch.ones((6, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="batch 6 not divisible by "
                                         "n_micro=4"):
        pipeline.gpipe_layers(enc, layers, x, mask, None, 2, 4,
                              Ring(2))
    # a data rank's 3 rows of a global batch of 6: microbatches of 3 do
    # not split over 2 data ranks
    with data_parallel(Layout(n_data=2)), pytest.raises(
            ValueError, match="microbatch size 3"):
        pipeline.gpipe_layers(enc, layers, x[:3], mask[:3], None, 2, 2,
                              Ring(2))


def test_berson_trunk_out_refuses_a_multimodal_inner():
    tc = tcfg.MultimodalConfig(encoder=tcfg.EncoderConfig.tiny(),
                               max_story_length=4)
    model = BersonOrdering(tc)
    model.cfg = dataclasses.replace(tc, multimodal=True)
    with pytest.raises(NotImplementedError, match="trunk_out"):
        model.encode({"input_ids": torch.zeros((1, 1, 4), dtype=torch.long)},
                      trunk_out=torch.zeros((1, 4, 64)))


# ----- four gloo ranks: 2 data x 2 pipeline stages --------------------------


@pytest.fixture(scope="module")
def pp_ranks(wikihow_dir, tmp_path_factory):
    work = str(tmp_path_factory.mktemp("pp"))
    text = _text_case(wikihow_dir, 4, 0.1)
    fsdp = dict(fsdp=True, fsdp_min_elems=FSDP_MIN)
    cases = {"text": dict(text, pipeline=(2, 2)),
             "text_fsdp": dict(text, pipeline=(2, 2),
                               heatmap_batch=dict(text["batches"][0]),
                               **fsdp),
             "berson_fsdp": dict(_berson_case(wikihow_dir, 0.1),
                                 pipeline=(2, 2), **fsdp)}
    got = run_ranks(4, 2, cases, work)
    want = {}
    for name, spec in cases.items():
        ref = dict(spec, pipeline=None)
        if "heatmap_batch" in spec:
            ref["workdir"] = str(tmp_path_factory.mktemp(name))
        want[name] = run_case(ref)
    return got, want, cases


@pytest.mark.parametrize("case", ["text", "text_fsdp", "berson_fsdp"])
def test_pipeline_ranks_match_one_process(pp_ranks, case):
    got, want, _ = pp_ranks
    _assert_matches(got[case], want[case])
    # FSDP2 holds the planned parameters as shards; without it none
    assert (got[case]["sharded_params"] > 0) == case.endswith("_fsdp")


def test_pipelined_fsdp_checkpoint_resumes_and_evaluates_in_one_process(
        pp_ranks):
    got, want, cases = pp_ranks
    res, spec = got["text_fsdp"], cases["text_fsdp"]
    assert res["resumed_step"] == len(spec["batches"])
    assert res["resumed_weights_equal"] and res["resumed_moments_equal"]
    model = SequencingModel(spec["cfg"])
    assert restore_checkpoint(res["checkpoint"], model) == len(
        spec["batches"])
    model.eval()
    db = device_batch(spec["heatmap_batch"], "cpu")
    with torch.no_grad():
        hm = model(db["input_ids"], db["attention_mask"],
                   db["token_type_ids"])["heatmap"].numpy()
    np.testing.assert_allclose(hm, res["heatmap"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(hm, want["text_fsdp"]["heatmap"], rtol=0,
                               atol=1e-5)
