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
and Adam moments. With `pipeline` = (stages, microbatches) a case trains
through the pipelined step (`parallel/pipeline.py`) on the model group's
ranks as stages; a case of kind "ring" runs ring attention instead.

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


def _ring_case(spec: dict, layout) -> dict:
    """Ring attention over a ring of `spec["ring"]` positions (the model
    group of a mesh of that many model ranks, each passing its own block
    of the sequence, or one process passing all of it): the whole output
    and the whole gradients of sum(sin(output)) with respect to q, k, v,
    the ranks' blocks joined here."""
    import torch.distributed as dist
    from multimodal_sequencing_tpu_torch.parallel.mesh import (
        Ring, make_mesh, model_ring)
    from multimodal_sequencing_tpu_torch.parallel.ring_attention import (
        ring_attention)
    ring = (Ring(spec["ring"]) if layout is None
            else model_ring(make_mesh(n_model=spec["ring"])))
    held = (torch.tensor(spec[n]) for n in ("q", "k", "v", "mask"))
    if ring.group is not None:
        held = (t.chunk(ring.size, 1 if t.dim() == 2 else 2)[ring.rank]
                for t in held)
    q, k, v, mask = held
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    out = ring_attention(q, k, v, mask, ring=ring)
    res = [out.detach(), *torch.autograd.grad(torch.sin(out).sum(),
                                              (q, k, v))]
    if ring.group is not None:
        parts = [[torch.empty_like(t) for _ in range(ring.size)]
                 for t in res]
        for p, t in zip(parts, res):
            dist.all_gather(p, t.contiguous(), group=ring.group)
        res = [torch.cat(p, 2) for p in parts]
    return {"out": res[0].numpy(), "grads": [g.numpy() for g in res[1:]]}


def _step_fn(spec: dict, layout):
    """The case's train step: `train/steps.py`'s own, or with `pipeline` =
    (stages, microbatches) the pipelined one, on the model group's ring
    (this process's ring without a layout)."""
    from multimodal_sequencing_tpu_torch.parallel import pipeline
    from multimodal_sequencing_tpu_torch.parallel.mesh import (
        Ring, model_ring)
    from multimodal_sequencing_tpu_torch.train import steps
    kind, pipe = spec["kind"], spec.get("pipeline")
    if not pipe:
        return (steps.berson_train_step if kind == "berson"
                else steps.train_step)
    ring = Ring(pipe[0]) if layout is None else model_ring(layout)
    if kind == "berson":
        return pipeline.make_berson_pipeline_train_step(spec["cfg"], ring,
                                                        *pipe)
    return pipeline.make_pipeline_train_step(spec["cfg"], ring, *pipe)[0]


def run_case(spec: dict, layout=None, workdir=None) -> dict:
    """Train the case's model on its batches on `layout` (None: this one
    process); returns its results as numpy (module docstring). A case of
    kind "ring" runs ring attention instead (`_ring_case`)."""
    if spec["kind"] == "ring":
        return _ring_case(spec, layout)
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
                                spec.get("fsdp_min_elems", 1 << 16),
                                pipeline=bool(spec.get("pipeline")))
        return model, AdamW(model, learning_rate=spec.get("lr", 2e-3),
                            warmup_steps=1, total_steps=10, weight_decay=0.01,
                            max_grad_norm=1.0)

    model, opt = build(spec.get("seed", 0), spec.get("weights"))
    par = parallel_of(model)
    step_fn = _step_fn(spec, layout)
    out = {"losses": [], "grad_norms": [], "terms": [],
           # parameters held as FSDP2 shards
           "sharded_params": sum(local(p) is not p
                                 for p in model.parameters())}
    for i, batch in enumerate(spec["batches"]):
        if spec["kind"] == "pretrain":
            objective, nb, aux = batch
            res = steps.pretrain_step(model, opt, nb, aux, objective, i,
                                      0)
        else:
            res = step_fn(model, opt, batch, i, 0)
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
