"""Each driver at test size on the CPU against the reference: a sound run
comes out correct, and each fault a cell can have, planted under the
timed path, comes out not correct. The control (the reference computed
with float8 operands) put in the program's place is not correct either.

Limits here are the test size's, in float32 on the CPU: the cells'
limits hold the bf16 program on the card at full size."""

import copy
import os

import numpy as np
import pytest
import torch

from benchmark.harness.common import load_module
from benchmark.reference import model as rmodel
from benchmark.tests.tiny import ROOT, cpu_run

TRAIN_LIMITS = {"loss_gap": 1e-3, "grad_gap": 1e-2, "grad_gap_median": 1e-3,
                "change_gap": 5e-2}
MM_TRAIN_LIMITS = dict(TRAIN_LIMITS, bn_stats_gap=1e-4, grad_share_gap=1e-2)
EVAL_LIMITS = {"order_faults": 0, "metric_gap": 1e-9, "heatmap_gap": 1e-3}
CASES = [("text-train-b192", TRAIN_LIMITS), ("mm-train-b40", MM_TRAIN_LIMITS)]
EVAL_CASES = [("text-eval-b32", EVAL_LIMITS), ("mm-eval-b8", EVAL_LIMITS)]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _correct(res):
    return all(c["ok"] for c in res["checks"].values()) and res["failed"] == 0


def _steps():
    from multimodal_sequencing_tpu_torch.train import steps
    return steps


def unchanged_step(model, opt, batch, step, seed):
    """A step that returns its state unchanged: the loss as computed,
    parameters, moments and counts as before."""
    saved = copy.deepcopy(model.state_dict())
    moments = [[t.clone() for t in ts] for ts in (opt.mu, opt.nu)]
    count = opt.count
    out = _steps().train_step(model, opt, batch, step, seed)
    model.load_state_dict(saved)
    for ts, old in zip((opt.mu, opt.nu), moments):
        for t, o in zip(ts, old):
            t.copy_(o)
    opt.count = count
    return out


def half_batch_step(model, opt, batch, step, seed):
    """Half of the batch left out, the mean taken over the rest: the step
    gets the first half of its rows."""
    half = len(batch["valid"]) // 2
    b = {k: (v[:half] if isinstance(v, (np.ndarray, list)) else v)
         for k, v in batch.items()}
    return _steps().train_step(model, opt, b, step, seed)


@pytest.mark.parametrize("cell,limits", CASES, ids=[c for c, _ in CASES])
def test_train_sound_run_is_correct(tmp_path, cell, limits):
    res = cpu_run(tmp_path, cell, limits)
    assert _correct(res), res["checks"]
    assert res["attempted"] > 0 and res["e2e"]["train_stories_per_s"] > 0


@pytest.mark.parametrize("fault", [unchanged_step, half_batch_step],
                         ids=["unchanged_state", "half_batch"])
@pytest.mark.parametrize("cell,limits", CASES, ids=[c for c, _ in CASES])
def test_train_fault_is_caught(tmp_path, cell, limits, fault):
    res = cpu_run(tmp_path, cell, limits, step_fn=fault)
    assert not _correct(res), res["checks"]


@pytest.mark.parametrize("cell,limits", CASES, ids=[c for c, _ in CASES])
def test_train_control_in_the_programs_place_is_caught(tmp_path, cell,
                                                       limits, monkeypatch):
    driver = load_module(os.path.join(ROOT, "benchmark", "drivers",
                                      "train.py"), "bench_driver_train")

    def control_steps(run, st):
        for _ in range(run.traffic["check_steps"]):
            next(st["feed"])
        return driver.reference(run, st["stories"], st["images"],
                                quant=rmodel.fp8)

    monkeypatch.setattr(driver, "first_steps", control_steps)
    import benchmark.tests.tiny as tiny
    monkeypatch.setattr(tiny, "load_module", lambda *a, **k: driver)
    res = tiny.cpu_run(tmp_path, cell, limits)
    assert not _correct(res), res["checks"]


@pytest.mark.parametrize("cell,limits", EVAL_CASES,
                         ids=[c for c, _ in EVAL_CASES])
def test_eval_sound_run_is_correct(tmp_path, cell, limits):
    res = cpu_run(tmp_path, cell, limits)
    assert _correct(res), res["checks"]
    assert res["attempted"] > 0 and res["e2e"]["eval_stories_per_s"] > 0


def _altered_order(decode):
    """The first order of each batch altered where it is produced."""
    def wrapped(heatmaps):
        orders = [list(o) for o in decode(heatmaps)]
        orders[0][0], orders[0][1] = orders[0][1], orders[0][0]
        return orders
    return wrapped


def _half_left_out(batch):
    b = dict(batch)
    valid = np.array(b["valid"], copy=True)
    valid[len(valid) // 2:] = False
    b["valid"] = valid
    return b


@pytest.mark.parametrize("fault", ["altered_order", "half_batch"])
@pytest.mark.parametrize("cell,limits", EVAL_CASES,
                         ids=[c for c, _ in EVAL_CASES])
def test_eval_fault_is_caught(tmp_path, cell, limits, fault):
    kw = ({"wrap_decode": _altered_order} if fault == "altered_order"
          else {"wrap_batch": _half_left_out})
    res = cpu_run(tmp_path, cell, limits, **kw)
    assert not _correct(res), res["checks"]


@pytest.mark.parametrize("cell,limits", EVAL_CASES,
                         ids=[c for c, _ in EVAL_CASES])
def test_eval_control_in_the_programs_place_is_caught(tmp_path, cell, limits,
                                                      monkeypatch):
    driver = load_module(os.path.join(ROOT, "benchmark", "drivers",
                                      "eval.py"), "bench_driver_eval")
    judge = driver.judge

    def control_records(run, st, picks, results):
        from benchmark.reference import data as rdata
        inputs = rdata.story_inputs(st["stories"], picks, run.seed, run.cfg,
                                    st["images"])
        hms = driver.reference_heatmaps(run, inputs, rmodel.fp8)
        orders = [o for r in st["evaluator"].records for o in r[1]]
        st["evaluator"].records = [(hms, orders)]
        return judge(run, st, picks, results)

    monkeypatch.setattr(driver, "judge", control_records)
    import benchmark.tests.tiny as tiny
    monkeypatch.setattr(tiny, "load_module", lambda *a, **k: driver)
    res = tiny.cpu_run(tmp_path, cell, limits)
    assert not _correct(res), res["checks"]
