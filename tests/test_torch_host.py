"""The port keeps its own copies of the JAX package's host modules; each
copy is pinned here to its original on the same inputs: tokenizer ids,
story packing, the WikiHow processor and sort dataset, every heat-map
decode method and every metric."""

import jax  # noqa: F401  (both frameworks load in one test process)
import numpy as np
import pytest
import torch

from multimodal_sequencing_tpu.data import datasets as jds
from multimodal_sequencing_tpu.data import packing as jpack
from multimodal_sequencing_tpu.data import tokenization as jtok
from multimodal_sequencing_tpu.data.registry import get_processor as j_get_processor
from multimodal_sequencing_tpu.utils import heatmap as jhm
from multimodal_sequencing_tpu.utils import metrics as jmet
from multimodal_sequencing_tpu_torch.data import datasets as tds
from multimodal_sequencing_tpu_torch.data import packing as tpack
from multimodal_sequencing_tpu_torch.data import tokenization as ttok
from multimodal_sequencing_tpu_torch.data.registry import get_processor as t_get_processor
from multimodal_sequencing_tpu_torch.utils import heatmap as thm
from multimodal_sequencing_tpu_torch.utils import metrics as tmet

torch.set_num_threads(1)

TEXTS = [
    "Gather all the tools you need. Make sure the workbench is clean.",
    "Measure the plank twice before cutting!",
    "<s> special </s> tokens, <mask> and <pad> inside; UPPER lower 123",
    "",
    "One " * 40,
]


@pytest.mark.parametrize("vocab", [1000, 50265])
def test_tokenizer_ids_match(vocab):
    j, t = jtok.SimpleWordTokenizer(vocab), ttok.SimpleWordTokenizer(vocab)
    for text in TEXTS:
        for kw in ({}, {"max_length": 12, "padding": "max_length",
                        "truncation": True}):
            assert t(text, **kw) == j(text, **kw)
    assert t(TEXTS, max_length=8, truncation=True,
             return_token_type_ids=True) == j(
        TEXTS, max_length=8, truncation=True, return_token_type_ids=True)
    assert len(t) == len(j)


@pytest.mark.parametrize("max_len,per_seq", [(96, 12), (48, 12), (320, 60),
                                             (16, 8)])
def test_pack_story_matches(max_len, per_seq):
    tok = ttok.load_tokenizer("simple")
    j = jpack.StoryPacker(jtok.load_tokenizer("simple"), max_len, per_seq)
    t = tpack.StoryPacker(tok, max_len, per_seq)
    for story in (TEXTS, TEXTS[:2], TEXTS[::-1]):
        for a, b in zip(t.pack_story(story), j.pack_story(story)):
            np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("split", ["train", "dev", "test", "acl22-train"])
def test_processor_and_sort_dataset_match(wikihow_dir, split):
    version, _, base = split.rpartition("-")
    kw = dict(data_dir=wikihow_dir, version_text=version or None,
              min_story_length=5, max_story_length=5)
    jproc = j_get_processor("wikihow_sort", paired_with_image=False, **kw)
    tproc = t_get_processor("wikihow_sort", **kw)
    getter = {"train": "get_train_examples", "dev": "get_dev_examples",
              "test": "get_test_examples"}[base]
    jex, tex = getattr(jproc, getter)(), getattr(tproc, getter)()
    assert [(e.guid, e.text_seq, e.multiref_gt) for e in tex] == [
        (e.guid, e.text_seq, e.multiref_gt) for e in jex]
    tok = ttok.load_tokenizer("simple")
    common = dict(max_length=96, per_seq_max_length=12, max_story_length=5,
                  seed=3)
    jset = jds.SortDataset(jex, jtok.load_tokenizer("simple"),
                           min_story_length=5, **common)
    tset = tds.SortDataset(tex, tok, **common)
    jb = list(jds.data_loader(jset, 4))
    tb = list(tds.data_loader(tset, 4))
    assert len(jb) == len(tb)
    for a, b in zip(tb, jb):
        assert a["texts"] == b["texts"] and a["guid"] == b["guid"]
        np.testing.assert_array_equal(a["labels"], b["labels"])
        np.testing.assert_array_equal(a["valid"], b["valid"])


def test_multiref_labels_match():
    from multimodal_sequencing_tpu_torch.data.examples import HeadExample
    ex = HeadExample(guid="g", text_seq=list("abcde"),
                     multiref_gt=[[1, 2, 3, 4, 5], [1, 3, 2, 4, 5]])
    for seed in range(3):
        idx = np.random.RandomState(seed).permutation(5)
        np.testing.assert_array_equal(tds._decode_labels(ex, idx, 5),
                                      jds._decode_labels(ex, idx, 5))


DECODE_METHODS = ["super_naive", "naive", "naive_v2", "naive_v3",
                  "naive_sum", "naive_v2_sum", "naive_v3_sum",
                  "topological", "mst"]


@pytest.mark.parametrize("method", DECODE_METHODS)
def test_heatmap2order_matches(method):
    rng = np.random.RandomState(len(method))
    for n in (3, 5, 6):
        for _ in range(6):
            hm = rng.rand(n, n)
            if "v3" in method:
                hm = hm * 2 - 1
            np.fill_diagonal(hm, 0)
            assert thm.heatmap2order(hm, method, beam_size=2) == \
                jhm.heatmap2order(hm, method, beam_size=2)


@pytest.mark.parametrize("metric", jmet.METRICS + [
    "head_prediction", "pairwise_prediction", "longest_common_subsequence",
    "longest_common_substring"])
def test_compute_metrics_matches(metric):
    rng = np.random.RandomState(0)
    labels = [rng.permutation(5) for _ in range(12)]
    preds = [list(rng.permutation(5)) for _ in range(11)] + [list(labels[-1])]
    assert tmet.compute_metrics(None, metric, preds, labels) == \
        jmet.compute_metrics(None, metric, preds, labels)


def test_multiref_metrics_match():
    class Args:
        max_story_length = 5
        multiref_metrics = "max"
    rng = np.random.RandomState(1)
    labels = [np.stack([rng.permutation(5) for _ in range(3)])
              for _ in range(6)]
    preds = [list(rng.permutation(5)) for _ in range(6)]
    for metric in jmet.METRICS:
        assert tmet.compute_metrics(Args, metric, preds, labels) == \
            jmet.compute_metrics(Args, metric, preds, labels)
