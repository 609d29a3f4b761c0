"""Multi-rank harness of the port's parallel tests: gloo ranks on the CPU.

`run_ranks(world, n_model, cases, workdir)` spawns `world` processes laid
out as (world / n_model data, n_model model) ranks, runs every case on each
and returns rank 0's results; `run_case(spec)` runs one case in this
process (the single-process reference). A case trains a model for a few
steps on given global batches and reports each step's loss terms and
gradient norm, the whole gradients and weights (BatchNorm statistics
included) after the first step, and, given `heatmap_batch`, the heat maps
of an eval forward, a checkpoint written after the last step, and whether
a fresh model of the same layout resumed from it holds the same weights
and Adam moments.

This module imports no JAX: the ranks import only the port.
"""

from __future__ import annotations

import os
import pickle
import socket
import time
import traceback

import torch
import torch.multiprocessing as mp


def run_ranks(world: int, n_model: int, cases: dict, workdir: str,
              timeout: float = 240.0) -> dict:
    """{case name: rank 0's results}. A rank that fails or a run past
    `timeout` seconds raises, the other ranks stopped."""
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "cases.pkl"), "wb") as f:
        pickle.dump(cases, f)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, world, port, n_model,
                                             workdir))
             for r in range(world)]
    for p in procs:
        p.start()
    t0 = time.time()
    try:
        while any(p.is_alive() for p in procs):
            bad = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
            if bad or time.time() - t0 > timeout:
                err = os.path.join(workdir, "error.txt")
                msg = open(err).read() if os.path.exists(err) else ""
                raise RuntimeError(f"ranks failed (exit codes {bad}, "
                                   f"{time.time() - t0:.0f} s):\n{msg}")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    if any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"ranks exited with {[p.exitcode for p in procs]}")
    with open(os.path.join(workdir, "rank0.pkl"), "rb") as f:
        return pickle.load(f)


def _rank(rank, world, port, n_model, workdir):
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    try:
        import torch.distributed as dist
        from multimodal_sequencing_tpu_torch.parallel.mesh import (
            init_distributed, make_mesh)
        init_distributed("cpu")
        layout = make_mesh(n_model=n_model)
        with open(os.path.join(workdir, "cases.pkl"), "rb") as f:
            cases = pickle.load(f)
        out = {name: run_case(spec, layout, workdir)
               for name, spec in cases.items()}
        if rank == 0:
            with open(os.path.join(workdir, "rank0.pkl"), "wb") as f:
                pickle.dump(out, f)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(workdir, "error.txt"), "a") as f:
            f.write(f"rank {rank}:\n{traceback.format_exc()}\n")
        raise


def _model(spec):
    from multimodal_sequencing_tpu_torch.models.berson import BersonOrdering
    from multimodal_sequencing_tpu_torch.models.pretrainer import (
        SequencingPretrainer)
    from multimodal_sequencing_tpu_torch.models.sequencer import (
        SequencingModel)
    cfg, vcfg = spec["cfg"], spec.get("vcfg")
    if spec["kind"] == "berson":
        return BersonOrdering(cfg, vcfg, beam_size=2, time_contrastive=True)
    if spec["kind"] == "pretrain":
        return SequencingPretrainer(cfg, vcfg)
    return SequencingModel(cfg, vcfg)


def run_case(spec: dict, layout=None, workdir=None) -> dict:
    """Train the case's model on its batches on `layout` (None: this one
    process); returns its results as numpy (module docstring)."""
    from multimodal_sequencing_tpu_torch.models.sequencer import init_weights
    from multimodal_sequencing_tpu_torch.parallel.sharding_rules import (
        full_state_dict, gathered, local, parallel_of, parallelize)
    from multimodal_sequencing_tpu_torch.train import steps
    from multimodal_sequencing_tpu_torch.train.checkpoint import (
        restore_checkpoint, save_checkpoint)
    from multimodal_sequencing_tpu_torch.train.state import AdamW

    def build(seed, weights=None):
        model = init_weights(_model(spec), seed)
        if weights:
            model.load_state_dict(torch.load(weights))
        if layout is not None:
            model = parallelize(model, layout,
                                spec.get("sequence_parallel", False),
                                spec.get("fsdp", False),
                                spec.get("fsdp_min_elems", 1 << 16))
        return model, AdamW(model, learning_rate=spec.get("lr", 2e-3),
                            warmup_steps=1, total_steps=10, weight_decay=0.01,
                            max_grad_norm=1.0)

    model, opt = build(spec.get("seed", 0), spec.get("weights"))
    par = parallel_of(model)
    out = {"losses": [], "grad_norms": [], "terms": []}
    for i, batch in enumerate(spec["batches"]):
        if spec["kind"] == "pretrain":
            objective, nb, aux = batch
            res = steps.pretrain_step(model, opt, nb, aux, objective, i,
                                      0)
        elif spec["kind"] == "berson":
            res = steps.berson_train_step(model, opt, batch, i, 0)
        else:
            res = steps.train_step(model, opt, batch, i, 0)
        out["losses"].append(res["loss"].item())
        out["grad_norms"].append(res["grad_norm"].item())
        out["terms"].append({k: v.item() for k, v in res.items()})
        if i == 0:
            grads = {}
            for name, p in model.named_parameters():
                g = local(p.grad) if p.grad is not None else \
                    torch.zeros_like(local(p))
                grads[name] = (g if par is None else par.full(name, g))
            out["grads"] = {k: v.numpy().copy() for k, v in grads.items()}
            out["weights"] = {k: v.numpy().copy() for k, v in
                              full_state_dict(model).items()}
    if "heatmap_batch" in spec:
        db = steps.device_batch(spec["heatmap_batch"], "cpu")
        model.eval()
        with gathered(model), torch.no_grad():
            hm = model(db["input_ids"], db["attention_mask"],
                       db["token_type_ids"])["heatmap"]
        out["heatmap"] = hm.numpy().copy()
        out["checkpoint"] = save_checkpoint(workdir or spec["workdir"],
                                            len(spec["batches"]), model, opt,
                                            spec["cfg"])
        # a fresh model of the same layout resumed from it
        model2, opt2 = build(spec.get("seed", 0) + 1)
        out["resumed_step"] = restore_checkpoint(out["checkpoint"], model2,
                                                 opt2)
        want, got = full_state_dict(model), full_state_dict(model2)
        out["resumed_weights_equal"] = all(torch.equal(got[k], want[k])
                                           for k in want)
        want, got = opt.state_dict(), opt2.state_dict()
        out["resumed_moments_equal"] = want["count"] == got["count"] and all(
            torch.equal(got[m][k], want[m][k])
            for m in ("mu", "nu") for k in want[m])
    return out
