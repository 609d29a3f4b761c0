"""The port's RecipeQA slice against the JAX package's, on the CPU: the
caption transformations, every registry key, the RecipeQA pairwise,
abductive and whole-story processors (the `images-qa` glob, recipe-id
dedup, the `new_splits` versions, `multiref_gt`) on a synthetic recipe
tree whose `new_splits` the port's `human_annotated_to_test` writes, that
writer and `output_to_tsv` themselves, the sort dataset over multiref
stories, and the three RecipeQA launchers (`scripts/recipeqa_*.sh`): their
flags parse as the JAX package parses them, and they run through the
port's CLIs at the tiny size with their own split versions."""

import dataclasses
import json
import os
import re
import shlex
import shutil

import jax  # noqa: F401 (the JAX package is held against)
import numpy as np
import pytest
import torch

from multimodal_sequencing_tpu.data import caption_transforms as jct
from multimodal_sequencing_tpu.data import datasets as jds
from multimodal_sequencing_tpu.data import recipeqa as jrq
from multimodal_sequencing_tpu.data import registry as jreg
from multimodal_sequencing_tpu.data import tokenization as jtok
from multimodal_sequencing_tpu.train import cli as jcli
from multimodal_sequencing_tpu_torch.data import caption_transforms as tct
from multimodal_sequencing_tpu_torch.data import datasets as tds
from multimodal_sequencing_tpu_torch.data import recipeqa as trq
from multimodal_sequencing_tpu_torch.data import registry as treg
from multimodal_sequencing_tpu_torch.data import tokenization as ttok
from multimodal_sequencing_tpu_torch.data.images import read_image_rgb
from multimodal_sequencing_tpu_torch.train import cli as tcli

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXTS = [
    "Preheat the oven to 200 degrees. Grease the tray well!",
    "Mix the flour and the sugar. Add two eggs? Yes, two.",
    "Knead the dough for 5 minutes. 'Rest' it under a cloth.",
    "Roll it out thin.",
    "Bake until golden. Cool on a rack. Serve warm.",
    "Dust with sugar (optional). Enjoy it.",
]


# ----- caption transformations and the registry -----------------------------


@pytest.mark.parametrize("text", TEXTS + ["", "one", "A. B. C.",
                                          "x!  Y? (Z) 3 apples. 4 pears."])
def test_sent_split_matches_jax(text):
    assert tct.sent_split(text) == jct.sent_split(text)


@pytest.mark.parametrize("spec", [
    ["remove_1st"], ["max_sentence_1"], ["max_sentence_2", "remove_1st"],
    ["remove_1st", "max_sentence_2"], []])
def test_caption_transformations_match_jax(spec):
    want = jct.CaptionTransformations(None, "recipeqa", spec)
    got = tct.CaptionTransformations(None, "recipeqa", spec)
    assert got.transform(TEXTS) == want.transform(TEXTS)
    assert got.transform(TEXTS[0]) == want.transform(TEXTS[0])
    with pytest.raises(NotImplementedError):
        tct.CaptionTransformations(None, "recipeqa", ["shuffle"])


@pytest.mark.parametrize("spec", [
    None, ["train_remove_1st"], ["eval_max_sentence_1"],
    ["train_remove_1st", "eval_max_sentence_2", "max_sentence_3"]])
@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_select_caption_transforms_matches_jax(spec, split):
    class Args:
        caption_transformations = spec

    want = jct.select_caption_transforms(Args, "recipeqa", split)
    got = tct.select_caption_transforms(Args, "recipeqa", split)
    assert (got is None) == (want is None)
    if want is not None:
        assert got.transform(TEXTS) == want.transform(TEXTS)


def test_registry_matches_jax(recipeqa_dir):
    assert set(treg.data_processors) == set(jreg.data_processors)
    for key, jcls in jreg.data_processors.items():
        tcls = treg.data_processors[key]
        assert (tcls is None) == (jcls is None), key
        if jcls is None:
            for get in (treg.get_processor, jreg.get_processor):
                with pytest.raises(NotImplementedError, match="no shipped"):
                    get(key)
            continue
        assert tcls.__name__ == jcls.__name__, key
        data = recipeqa_dir if key.startswith("recipeqa") else None
        assert treg.get_processor(key, data_dir=data).get_labels() == \
            jreg.get_processor(key, data_dir=data).get_labels()
    assert {"recipeqa_sort", "recipeqa_pretrain", "recipeqa_hl_v1",
            "recipeqa_pairwise", "recipeqa_head", "recipeqa_abductive",
            "recipeqa_pure_class", "wikihow_pairwise", "wikihow_head",
            "wikihow_abductive", "wikihow_pure_class"} <= {
        k for k, v in treg.data_processors.items() if v}


# ----- the recipe tree --------------------------------------------------------


def _png(path, seed):
    from PIL import Image
    rng = np.random.RandomState(seed)
    Image.fromarray(rng.randint(0, 255, (40, 48, 3), dtype=np.uint8)).save(
        path, format="PNG")


# the new_splits versions the launchers name, written by
# human_annotated_to_test: human_annot (train-human_annot,
# test-human_annot_only), acl_human (test-acl_human), acl22
# (train-acl22), acl22_human (test-acl22_human)
VERSIONS = ("human_annot", "acl_human", "acl22", "acl22_human")
MULTIREF = [[1, 2, 3, 4, 5], [2, 1, 3, 4, 5]]


def recipe_tree(root, src, writer=trq.human_annotated_to_test):
    """`src` (the `recipeqa_dir` fixture) copied to `root`, with more
    recipes: a duplicate record (read once), a 3-step recipe (too short),
    a recipe of 6 steps whose step 2 has no image and step 3 two, and
    multiref ground truth on every test recipe (a file that mixes recipes
    with and without it fails in both packages): two references for
    `test-recipe_1`, which is also the one human-annotated; then `writer`
    writes each of VERSIONS under `new_splits/`."""
    shutil.copytree(src, root)
    img_dir = os.path.join(root, "images", "images-qa", "train", "images-qa")
    with open(os.path.join(root, "texts", "train.json")) as f:
        train = json.load(f)
    train["data"].append(dict(train["data"][0]))
    train["data"].append({"recipe_id": "train-short", "context": [
        {"id": s, "body": TEXTS[s]} for s in range(3)]})
    train["data"].append({"recipe_id": "train-gap", "context": [
        {"id": s, "body": TEXTS[s]} for s in range(6)]})
    for s in range(3):
        _png(os.path.join(img_dir, f"train-short_{s}_0.jpg"), 100 + s)
    for s in (0, 1, 3, 4, 5):
        _png(os.path.join(img_dir, f"train-gap_{s}_0.jpg"), 200 + s)
    _png(os.path.join(img_dir, "train-gap_3_1.jpg"), 300)
    with open(os.path.join(root, "texts", "train.json"), "w") as f:
        json.dump(train, f)
    with open(os.path.join(root, "texts", "test.json")) as f:
        test = json.load(f)
    test["data"][0]["multiref_gt"] = MULTIREF[:1]
    test["data"][1]["multiref_gt"] = MULTIREF
    with open(os.path.join(root, "texts", "test.json"), "w") as f:
        json.dump(test, f)
    human = os.path.join(root, "human.jsonl")
    with open(human, "w") as f:
        f.write(json.dumps({"guid": "test-recipe_1"}) + "\n")
    for version in VERSIONS:
        writer(root, [human], out_dir=os.path.join(root, "new_splits"),
               version=version)
    return str(root)


@pytest.fixture(scope="module")
def recipes(recipeqa_dir, tmp_path_factory):
    return recipe_tree(str(tmp_path_factory.mktemp("rq") / "tree"),
                       recipeqa_dir)


def test_human_annotated_to_test_matches_jax(recipeqa_dir, tmp_path):
    port = recipe_tree(str(tmp_path / "port"), recipeqa_dir)
    jax_ = recipe_tree(str(tmp_path / "jax"), recipeqa_dir,
                       writer=jrq.human_annotated_to_test)
    names = sorted(os.listdir(os.path.join(port, "new_splits")))
    assert names == sorted(os.listdir(os.path.join(jax_, "new_splits")))
    assert len(names) == 4 * len(VERSIONS)
    for name in names:
        with open(os.path.join(port, "new_splits", name)) as a, \
                open(os.path.join(jax_, "new_splits", name)) as b:
            assert a.read() == b.read(), name
    with open(os.path.join(port, "new_splits", "test-acl_human.json")) as f:
        test = json.load(f)["data"]
    # the human-annotated recipe goes last, with its multiref ground truth
    assert test[-1]["recipe_id"] == "test-recipe_1"
    assert test[-1]["multiref_gt"] == MULTIREF
    # a recipe of val that is also in train is refused
    bad = os.path.join(port, "texts", "val.json")
    with open(bad) as f:
        val = json.load(f)
    val["data"].append({"recipe_id": "train-recipe_0", "context": []})
    with open(bad, "w") as f:
        json.dump(val, f)
    with pytest.raises(ValueError, match="is in train"):
        trq.human_annotated_to_test(port, [], out_dir=str(tmp_path / "x"))


PROCESSORS = {
    "pairwise_tight": ("recipeqa_pairwise", dict(order_criteria="tight")),
    "pairwise_loose": ("recipeqa_pairwise", dict(order_criteria="loose")),
    "abductive": ("recipeqa_abductive", {}),
    "sort": ("recipeqa_sort", {}),
    "pure_class": ("recipeqa_pure_class", dict(pure_class=True)),
}


@pytest.mark.parametrize("version", [None, "human_annot", "acl22"])
@pytest.mark.parametrize("images", [True, False])
@pytest.mark.parametrize("case", sorted(PROCESSORS))
def test_recipeqa_processors_match_jax(recipes, case, images, version):
    task, kw = PROCESSORS[case]
    for spec in (None, ["eval_max_sentence_1", "train_remove_1st"]):
        class Args:
            caption_transformations = spec
        for split in ("train", "val", "test"):
            args = dict(kw, data_dir=recipes, paired_with_image=images,
                        version_text=version)
            jproc = jreg.get_processor(task, **args, caption_transforms=(
                jct.select_caption_transforms(Args, "recipeqa", split)))
            tproc = treg.get_processor(task, **args, caption_transforms=(
                tct.select_caption_transforms(Args, "recipeqa", split)))
            get = {"train": "get_train_examples", "val": "get_dev_examples",
                   "test": "get_test_examples"}[split]
            want = getattr(jproc, get)()
            got = getattr(tproc, get)()
            assert want, (case, split)
            assert [dataclasses.asdict(e) for e in got] == \
                [dataclasses.asdict(e) for e in want], (case, split)
            assert tproc.multiref_gt == jproc.multiref_gt
            assert tproc.get_labels() == jproc.get_labels()
    if case == "sort" and version is None:
        stories = treg.get_processor(
            task, data_dir=recipes, paired_with_image=images
        ).get_train_examples()
        ids = [e.guid for e in stories]
        # the duplicate is read once, the 3-step recipe is skipped
        assert ids.count("train-recipe_0") == 1 and "train-short" not in ids
        gap = stories[ids.index("train-gap")]
        if images:  # step 2 has no image: dropped; step 3's first image
            assert gap.text_seq == [TEXTS[s] for s in (0, 1, 3, 4, 5)]
            assert gap.img_path_seq[2].endswith("train-gap_3_0.jpg")
        else:
            assert gap.img_path_seq[2] is None


def test_missing_version_file_raises(recipes):
    proc = trq.RecipeQAGeneralProcessor(data_dir=recipes,
                                        version_text="nope")
    with pytest.raises(ValueError, match="not found"):
        proc.get_train_examples()


def test_multiref_sort_dataset_matches_jax(recipes):
    kw = dict(data_dir=recipes, version_text="human_annot_only")
    jex = jrq.RecipeQAGeneralProcessor(**kw).get_test_examples()
    tex = trq.RecipeQAGeneralProcessor(**kw).get_test_examples()
    assert [e.multiref_gt for e in tex] == [MULTIREF]
    common = dict(max_length=96, per_seq_max_length=12, max_story_length=5,
                  seed=2, multimodal=True, image_size=(32, 32))
    jset = jds.SortDataset(jex, jtok.load_tokenizer("simple"), **common)
    tset = tds.SortDataset(tex, ttok.load_tokenizer("simple"), **common)
    got, want = tset[0], jset[0]
    assert got["labels"].shape == (2, 5)
    for key in ("labels", "images"):
        np.testing.assert_array_equal(got[key], want[key])
    assert got["texts"] == want["texts"] and got["guid"] == want["guid"]
    # every step image decodes to a non-zero array
    assert all(read_image_rgb(p).any() for p in tex[0].img_path_seq)


def test_output_to_tsv_matches_jax(recipes, tmp_path):
    jrq.output_to_tsv(recipes, str(tmp_path / "jax"))
    trq.output_to_tsv(recipes, str(tmp_path / "port"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert {"train.tsv", "dev.tsv", "test.tsv", "human_test.tsv",
            "test_examples.json", "human_test_examples.json"} == set(names)
    for name in names:
        assert (tmp_path / "port" / name).read_text() == (
            tmp_path / "jax" / name).read_text(), name


# ----- the launchers ----------------------------------------------------------


LAUNCHERS = {"recipeqa_finetune.sh": "train",
             "recipeqa_pretrain.sh": "pretrain",
             "recipeqa_image_only_pretrain.sh": "pretrain"}


def launcher_argv(script):
    """The flags a launcher passes to the JAX entry point, its shell
    variables at their defaults, the CLIP weights and "$@" left out."""
    with open(os.path.join(ROOT, "scripts", script)) as f:
        text = f.read()
    env = {}

    def expand(s):
        return re.sub(r"\$\{(\w+)\}", lambda m: env[m.group(1)], s)

    for name, value in re.findall(r'^(\w+)="(.*)"$', text, re.M):
        default = re.fullmatch(r"\$\{\w+:-(.*)\}", value)
        env[name] = expand(default.group(1) if default else value)
    call = text[text.index("python3 -m"):].replace("\\\n", " ")
    call = call.replace('"${CLIP_WEIGHTS_FLAG[@]}"', "").replace('"$@"', "")
    argv = shlex.split(re.sub(r"\$\{(\w+)\}", lambda m: env[m.group(1)],
                              call))
    assert argv[:2] == ["python3", "-m"]
    assert argv[2].startswith("multimodal_sequencing_tpu.trainers.")
    return argv[3:]


@pytest.mark.parametrize("script", sorted(LAUNCHERS))
def test_launcher_flags_parse_as_in_jax(script):
    kind = LAUNCHERS[script]
    argv = launcher_argv(script) + ["--tokenizer_name", "simple"]
    want = vars(jcli.resolve_args(jcli.build_parser(kind).parse_args(argv)))
    got = vars(tcli.parse_args(kind, argv))
    assert got.pop("device") == "cuda"
    assert got == {k: want[k] for k in got}
    # each keeps its own split versions
    split = argv[argv.index("--train_split") + 1]
    assert "-" in split and "-" in argv[argv.index("--eval_splits") + 1]


def run_launcher(script, data_dir, out, *extra):
    """A launcher's flags at the tiny size on the CPU, with its own split
    versions: 2 steps with a save at 2, one eval batch."""
    argv = launcher_argv(script)
    seq = min(100, int(argv[argv.index("--max_seq_length") + 1]))
    main = {"train": tcli.main_train, "pretrain": tcli.main_pretrain}[
        LAUNCHERS[script]]
    data = (["--data_dir", data_dir] if LAUNCHERS[script] == "train"
            else ["--data_dirs", data_dir])
    return main(argv + data + [
        "--max_seq_length", str(seq), "--per_seq_max_length", str(seq // 5),
        "--tokenizer_name", "simple", "--model_size", "tiny",
        "--output_root", str(out), "--output_dir", "run", "--max_steps", "2",
        "--save_steps", "2", "--logging_steps", "1", "--max_eval_steps", "1",
        "--device", "cpu", *extra])


def test_finetune_launcher_runs(recipes, tmp_path):
    # BERSON over the CLIP inner on train-human_annot, the beam eval on
    # test-acl_human (its last recipe carries multiref_gt) at the save and
    # after training
    res = run_launcher("recipeqa_finetune.sh", recipes, tmp_path,
                       "--beam_size", "2", "--vision_image_size", "32")
    run = tmp_path / "run"
    assert res.global_step == 2
    assert (run / "checkpoint-2" / "model.pt").is_file()
    assert (run / "checkpoint-best" / "model.pt").is_file()
    with open(run / "eval_results_split_test-acl_human_checkpoint-2.txt") as f:
        keys = {line.split(" = ")[0] for line in f}
    assert keys == {"partial_match", "exact_match", "tau"}


@pytest.mark.parametrize("script,objectives", [
    ("recipeqa_pretrain.sh", ["image_swapping"]),
    ("recipeqa_image_only_pretrain.sh", [])])
def test_pretrain_launchers_run(recipes, tmp_path, script, objectives):
    # train-human_annot / test-human_annot_only, and train-acl22 /
    # test-acl22_human; 224 px for the patch objectives' 7 x 7 grid
    extra = ["--vision_image_size", "224"]
    if objectives:
        extra += ["--multimodal_pretrain_objectives", *objectives]
    res = run_launcher(script, recipes, tmp_path, *extra)
    assert res.global_step == 2
    run = tmp_path / "run"
    assert (run / "checkpoint-2" / "model.pt").is_file()
    with open(run / "eval_results_pretrain.txt") as f:
        final = {k: float(v) for k, _, v in
                 (line.strip().partition(" = ") for line in f)}
    assert final and all(np.isfinite(v) for v in final.values())
