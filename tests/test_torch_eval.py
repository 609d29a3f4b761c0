"""The port's slice as a whole: `SortEvaluator.evaluate(..., "heat_map")` of
the JAX package and of the port on the same moved weights give identical
orders and metrics; the port's eval CLI runs on the CPU when asked and
fails without a card otherwise; the port imports nothing of JAX."""

import logging
import os
import pkgutil
import re
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sequencing_tpu.data import datasets as jds
from multimodal_sequencing_tpu.data import packing as jpack
from multimodal_sequencing_tpu.data import tokenization as jtok
from multimodal_sequencing_tpu.data.registry import get_processor as j_get_processor
from multimodal_sequencing_tpu.models import config as jcfg
from multimodal_sequencing_tpu.models.sequencer import (
    SequencingModel as JSequencingModel)
from multimodal_sequencing_tpu.train.evaluation import (
    SortEvaluator as JSortEvaluator)
import multimodal_sequencing_tpu_torch
from multimodal_sequencing_tpu_torch.data import datasets as tds
from multimodal_sequencing_tpu_torch.data import packing as tpack
from multimodal_sequencing_tpu_torch.data import tokenization as ttok
from multimodal_sequencing_tpu_torch.data.registry import get_processor as t_get_processor
from multimodal_sequencing_tpu_torch.models import config as tcfg
from multimodal_sequencing_tpu_torch.models.convert import params_from_jax
from multimodal_sequencing_tpu_torch.models.sequencer import SequencingModel
from multimodal_sequencing_tpu_torch.train import cli as tcli
from multimodal_sequencing_tpu_torch.train.evaluation import (
    SortEvaluator as TSortEvaluator)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "multimodal_sequencing_tpu_torch"
MAX_LEN, PER_SEQ, BATCH = 96, 12, 4


def _cfgs(version, method):
    kw = dict(hierarchical_version=version, heatmap_decode_method=method,
              max_story_length=5, max_seq_length=MAX_LEN,
              per_seq_max_length=PER_SEQ)
    # the simple tokenizer's ids span 50265 words, as in the CLI's tiny model
    enc = dict(gelu_impl="erf", type_vocab_size=5, vocab_size=50265)
    return (jcfg.MultimodalConfig(encoder=jcfg.EncoderConfig.tiny(**enc), **kw),
            tcfg.MultimodalConfig(encoder=tcfg.EncoderConfig.tiny(**enc), **kw))


def _loaders(wikihow_dir, split="train"):
    kw = dict(data_dir=wikihow_dir, min_story_length=5, max_story_length=5)
    common = dict(max_length=MAX_LEN, per_seq_max_length=PER_SEQ,
                  max_story_length=5, seed=0)
    jex = getattr(j_get_processor("wikihow_sort", paired_with_image=False,
                                  **kw), f"get_{split}_examples")()
    tex = getattr(t_get_processor("wikihow_sort", **kw),
                  f"get_{split}_examples")()
    return (jds.data_loader(jds.SortDataset(
                jex, jtok.load_tokenizer("simple"), **common), BATCH),
            tds.data_loader(tds.SortDataset(
                tex, ttok.load_tokenizer("simple"), **common), BATCH))


def _jax_and_port_models(jc, tc, seed):
    ids = np.full((1, MAX_LEN), jc.pad_id, np.int32)
    ids[0, 0] = jc.cls_id
    model = JSequencingModel(jc)
    variables = jax.tree.map(
        np.asarray, model.init(jax.random.PRNGKey(seed), jnp.asarray(ids)))
    port = SequencingModel(tc)
    port.load_state_dict(params_from_jax(variables, tc))
    return (model, variables), port.eval()


def _read(path):
    return Path(path).read_text()


@pytest.mark.parametrize("version,method", [
    ("v1", "naive_v2_sum"), ("v2", "naive_v2"), ("v3", "naive_v3_sum"),
    ("v1", "topological"), ("v1", "mst")])
def test_eval_slice_matches_jax(wikihow_dir, tmp_path, version, method):
    jc, tc = _cfgs(version, method)
    jmodel, tmodel = _jax_and_port_models(jc, tc, seed=11)
    jloader, tloader = _loaders(wikihow_dir)
    tok = ttok.load_tokenizer("simple")
    jres = JSortEvaluator(
        jc, jpack.StoryPacker(jtok.load_tokenizer("simple"), MAX_LEN, PER_SEQ),
        micro_batch=BATCH * 4).evaluate(
            jloader, "heat_map", {"heatmap": jmodel},
            output_dir=str(tmp_path / "jax"), data_split="train")
    evaluator = TSortEvaluator(tc, tpack.StoryPacker(tok, MAX_LEN, PER_SEQ),
                               device="cpu", micro_batch=BATCH * 4)
    tres = evaluator.evaluate(tloader, "heat_map", {"heatmap": tmodel},
                              output_dir=str(tmp_path / "port"),
                              data_split="train")
    assert tres == jres
    for name in ("output_order.txt", "all_predictions.csv",
                 "eval_results_split_train.txt"):
        assert _read(tmp_path / "port" / name) == _read(tmp_path / "jax" / name)
    assert evaluator.forwards == 2
    assert len(evaluator.forward_seconds) == len(evaluator.decode_seconds) == 2


def _cli_args(wikihow_dir, out, *extra):
    return ["--model_name_or_path", "simple", "--model_size", "tiny",
            "--task_name", "wikihow_sort", "--sort_method", "heat_map",
            "--hierarchical_version", "v1", "--replace_token_type_embeddings",
            "--data_dir", wikihow_dir, "--max_seq_length", str(MAX_LEN),
            "--per_seq_max_length", str(PER_SEQ), "--per_gpu_eval_batch_size",
            str(BATCH), "--seed", "0", "--output_dir", str(out), *extra]


def test_eval_cli_on_cpu_writes_outputs(wikihow_dir, tmp_path, caplog):
    out = tmp_path / "run"
    with caplog.at_level(logging.INFO):
        res = tcli.main_eval(_cli_args(wikihow_dir, out, "--eval_splits",
                                       "dev", "test", "--device", "cpu"))
    assert set(res) == {"dev", "test"}
    assert set(res["dev"]) == {"partial_match", "exact_match", "lcs_substr",
                               "lcs", "tau", "ms", "wms", "distance_based"}
    for name in ("output_order.txt", "all_predictions.csv",
                 "eval_results_split_dev.txt", "eval_results_split_test.txt"):
        assert (out / name).exists()
    orders = [line.split() for line in _read(out / "output_order.txt").split("\n")
              if line]
    assert all(sorted(map(int, o)) == list(range(5)) for o in orders)
    assert "& PM    & EM    & Lseq & Lstr & tau  & Dist." in caplog.text


def test_eval_cli_loads_the_port_checkpoint(wikihow_dir, tmp_path):
    # a JAX-initialised model saved in the port's format (config.json +
    # model.pt) evaluates through the CLI exactly as the JAX evaluator does
    jc, tc = _cfgs("v1", "naive_v2_sum")
    jmodel, tmodel = _jax_and_port_models(jc, tc, seed=5)
    ckpt = tmp_path / "ckpt"
    tcli.save_model(tmodel, tc, str(ckpt))
    res = tcli.main_eval(_cli_args(wikihow_dir, tmp_path / "run",
                                   "--model_name_or_path_1", str(ckpt),
                                   "--eval_splits", "train",
                                   "--gelu_impl", "erf", "--device", "cpu"))
    jloader, _ = _loaders(wikihow_dir)
    jres = JSortEvaluator(
        jc, jpack.StoryPacker(jtok.load_tokenizer("simple"), MAX_LEN, PER_SEQ),
        micro_batch=BATCH * 4).evaluate(jloader, "heat_map",
                                        {"heatmap": jmodel}, args_ns=None)
    assert res["train"] == jres


def test_eval_cli_without_card_fails_unless_cpu_is_asked(wikihow_dir,
                                                         tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main_eval(_cli_args(wikihow_dir, tmp_path / "run"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multimodal_sequencing_tpu_torch.resolve_device("cuda")
    assert multimodal_sequencing_tpu_torch.resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("method", ["topological", "pure_class"])
def test_other_sort_methods_are_later_slices(wikihow_dir, tmp_path, method):
    args = _cli_args(wikihow_dir, tmp_path / "run", "--device", "cpu")
    args[args.index("heat_map")] = method
    with pytest.raises(NotImplementedError):
        tcli.main_eval(args)


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [str(PORT)], prefix="multimodal_sequencing_tpu_torch."))


def test_port_imports_without_jax():
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'flax', 'optax',"
            " 'multimodal_sequencing_tpu'):\n"
            "    sys.modules[name] = None\n"
            "import importlib\n"
            f"for mod in {_port_modules()!r}:\n"
            "    importlib.import_module(mod)\n"
            "import chip_smoke\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
    assert len(_port_modules()) >= 20


def test_no_port_file_names_jax():
    pattern = re.compile(r"multimodal_sequencing_tpu\.|\bjax\b|"
                         r"^\s*(import|from)\s+(flax|optax)\b", re.M)
    files = [p for p in PORT.rglob("*") if p.suffix in (".py", ".cu")]
    files.append(REPO / "chip_smoke.py")
    hits = [f"{p}: {m.group(0)}" for p in files
            for m in pattern.finditer(p.read_text())]
    assert not hits
    assert len(files) >= 20


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_card(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cwd = REPO
    if alone:  # a directory holding chip_smoke.py and nothing else
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
