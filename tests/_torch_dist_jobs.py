"""Multi-process jobs of the port's mesh tests: one process per rank, gloo
on the CPU.

``run_world(world, job, *args)`` spawns ``world`` ranks, each of which
starts a gloo process group (a file store in a temporary directory: no
port to race for), calls
``job(*args)`` and saves what it returns; the parent gets the list of the
ranks' results, or the first failing rank's traceback as an error.  A
spawned rank imports this module by name, so it imports nothing of the
JAX package (a rank would load JAX to find its job).  The world-size-1
runs the ranks are held against call the same helpers without a mesh;
they run in the ranks too, spread over them after the mesh work
(:func:`spread`), where each process computes on one thread: the test
process's many threads would contend with the other test workers.
"""
import dataclasses
import os
import tempfile
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

from repro_torch.configs import SMOKE_SHAPES, get_config, make_batch
from repro_torch.distributed import steps
from repro_torch.models import lm
from repro_torch.optim.adamw import adamw

LR = 1e-3


def _entry(rank, world, job, args, outdir):
    import torch.distributed as dist
    path = os.path.join(outdir, f"rank{rank}.pt")
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{outdir}/store", rank=rank,
                                world_size=world)
        try:
            out = job(*args)
        finally:
            dist.destroy_process_group()
        torch.save({"ok": out}, path)
    except BaseException:
        torch.save({"error": traceback.format_exc()}, path)
        raise


def run_world(world: int, job, *args, timeout: float = 300.0) -> list:
    """``job(*args)`` on each of ``world`` gloo ranks: their results, by rank."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as outdir:
        procs = [ctx.Process(target=_entry, args=(r, world, job, args, outdir))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results = []
        for r, p in enumerate(procs):
            path = os.path.join(outdir, f"rank{r}.pt")
            got = torch.load(path, weights_only=False) if os.path.exists(path) else None
            if got is None or "error" in got:
                raise RuntimeError(f"rank {r} of {world} failed (exit {p.exitcode}):\n"
                                   f"{got['error'] if got else 'no result'}")
            results.append(got["ok"])
        return results


def mesh_of(shape):
    from repro_torch.launch.mesh import make_local_mesh
    return make_local_mesh(data=shape[0], model=shape[1], device="cpu")


def rank0() -> bool:
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


# --------------------------------------------------------------- training
def train_batch(cfg, batch: int = 8, seed: int = 0):
    """SMOKE ``train_4k`` rows with an uneven loss mask: the first data
    shard's rows 0 and 1 partly zeroed."""
    shape = dataclasses.replace(SMOKE_SHAPES["train_4k"], batch=batch)
    b = make_batch(cfg, shape, seed=seed, device="cpu")["batch"]
    b["loss_mask"][0, :20] = 0.0
    b["loss_mask"][1, 10:] = 0.0
    return b


def microbatch_order(batch, data: int, microbatches: int):
    """``batch``'s rows in a mesh step's microbatch order: microbatch i is
    the i-th contiguous slice of every data shard, rank-major."""
    B = next(iter(batch.values())).shape[0]
    per = B // data
    mb = per // microbatches
    idx = [r * per + i * mb + j for i in range(microbatches) for r in range(data)
           for j in range(mb)]
    return {k: v[idx] for k, v in batch.items()}


def model_of(arch, weights=None, tp_block="gspmd"):
    cfg = dataclasses.replace(get_config(arch, reduced=True), tp_block=tp_block)
    model = lm.init_params(cfg, seed=0, device="cpu")
    if weights is not None:
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(weights[n])
    return model


def one_step(arch, shape=None, *, batch=8, microbatches=2, grad_compress=None, weights=None,
             order=None, eps=1e-8, tp_block="gspmd"):
    """(metrics as floats, the parameters after one AdamW step: on rank 0
    only, on a mesh) of reduced ``arch`` from seed-0 weights (or ``weights``), on a mesh of
    ``shape`` or, without one, on one device with the batch's rows in
    ``order``'s microbatch order ((data, microbatches)).  ``eps`` is
    AdamW's; ``tp_block`` the config's."""
    model = model_of(arch, weights, tp_block)
    opt = adamw(LR, eps=eps)
    b = train_batch(model.cfg, batch)
    if order is not None:
        b = microbatch_order(b, *order)
    if shape is None:
        state = opt.init(dict(model.named_parameters()))
        m = steps.make_train_step(opt, microbatches=microbatches,
                                  grad_compress=grad_compress)(model, state, b)
    else:
        mesh = mesh_of(shape)
        state = steps.shard_state(model, opt, mesh)
        m = steps.make_train_step(opt, mesh=mesh, microbatches=microbatches,
                                  grad_compress=grad_compress)(model, state, b)
        steps.gather_params(model, state)
    metrics = {k: float(v) for k, v in m.items() if k in ("loss", "aux", "grad_norm")}
    keep = shape is None or rank0()          # a mesh's ranks hold the same parameters
    params = {n: p.detach().clone() for n, p in model.named_parameters()} if keep else None
    return metrics, params


def train_cases(cases):
    """Each (key, arch, shape, kwargs) of ``cases`` through :func:`one_step`."""
    return {key: one_step(arch, shape, **kw) for key, arch, shape, kw in cases}


def spread(calls):
    """``{key: fn(*args, **kwargs)}`` of the (key, fn, args, kwargs) in
    ``calls`` whose index is this rank's modulo the world size: work
    without collectives, shared out.  :func:`merged` joins the ranks'
    parts."""
    import torch.distributed as dist
    rank, world = dist.get_rank(), dist.get_world_size()
    return {key: fn(*args, **kw) for i, (key, fn, args, kw) in enumerate(calls)
            if i % world == rank}


def merged(parts):
    """The ranks' :func:`spread` results as one dict."""
    out = {}
    for part in parts:
        out.update(part)
    return out


# ---------------------------------------------------------------- serving
SERVE = dict(batch=4, prompt_len=16, gen_len=4, seed=0)


def serve_one(arch, shape=None):
    """Reduced ``arch`` from seed-0 weights: ``serve_batch``'s tokens, the
    prefill step's last logits and one decode step's logits (the global
    batch, gathered over the data ranks), on a mesh of ``shape`` or on
    one device."""
    from repro_torch.launch import serve
    cfg = get_config(arch, reduced=True)
    model = lm.init_params(cfg, seed=0, device="cpu")
    mesh = mesh_of(shape) if shape is not None else None
    out = serve.serve_batch(cfg, device="cpu", params=model, mesh=mesh, manage_runtime=True,
                            **SERVE)
    prompts = {k: torch.from_numpy(v) for k, v in
               serve.make_prompts(cfg, SERVE["batch"], SERVE["prompt_len"], 0).items()}
    prefill = steps.make_prefill_step(cache_len=SERVE["prompt_len"] + SERVE["gen_len"],
                                      mesh=mesh)
    decode = steps.make_decode_step(mesh=mesh)
    logits, caches = prefill(model, prompts)
    tok = torch.from_numpy(out["tokens"][:, :1])
    step_logits, _ = decode(model, {"tokens": tok}, caches, SERVE["prompt_len"])
    if mesh is not None:
        logits = steps.gather_rows(logits, mesh, SERVE["batch"])
        step_logits = steps.gather_rows(step_logits, mesh, SERVE["batch"])
    return {"tokens": np.asarray(out["tokens"]), "prefill": logits, "decode": step_logits}


def serve_cases(cases):
    return {key: serve_one(arch, shape) for key, arch, shape in cases}


def plain_run(ckpt_dir):
    """The elastic test's training on one device: its losses, and its
    step-2 checkpoint under ``ckpt_dir``."""
    from repro_torch.launch import train
    cfg = get_config("qwen3-0.6b", reduced=True)
    return train.train_loop(cfg, steps=3, ckpt_dir=ckpt_dir, ckpt_every=2,
                            model=lm.init_params(cfg, seed=0, device="cpu"),
                            **ELASTIC)["losses"]


def in_order(calls):
    """Several jobs in one spawn: ``[fn(*args) for fn, args in calls]``."""
    return [fn(*args) for fn, args in calls]


# ---------------------------------------------------------- elastic restore
ELASTIC = dict(batch=8, seq=32, lr=LR, warmup=1, workers=2, seed=0, log_every=0,
               device="cpu")


def elastic(ckpt_root, save_shape, restore_shapes, steps_total=3):
    """``train_loop`` on a ``save_shape`` mesh for ``steps_total`` steps
    with a checkpoint after step 2 (the runtime's ``checkpoint_save``
    task), then for each of ``restore_shapes`` a launch on that mesh
    restored from the step-2 checkpoint, which runs the last step.  Rank
    0 also saves the step-2 state through the one-device path (a plain
    model and AdamW state holding the gathered tensors) beside the
    sharded save, for a byte comparison."""
    import shutil

    import torch.distributed as dist

    from repro_torch.checkpoint.manager import save_checkpoint
    from repro_torch.launch import train
    cfg = get_config("qwen3-0.6b", reduced=True)
    first = os.path.join(ckpt_root, "first")
    out = {"first": train.train_loop(cfg, steps=steps_total, ckpt_dir=first, ckpt_every=2,
                                     mesh=mesh_of(save_shape),
                                     model=lm.init_params(cfg, seed=0, device="cpu"),
                                     **ELASTIC)["losses"]}
    for shape in restore_shapes:
        d = os.path.join(ckpt_root, "x".join(map(str, shape)))
        if rank0():
            os.makedirs(d)
            shutil.copytree(os.path.join(first, "step_00000002"),
                            os.path.join(d, "step_00000002"))
        dist.barrier()
        run = train.train_loop(cfg, steps=steps_total, ckpt_dir=d, restore=True,
                               mesh=mesh_of(shape),
                               model=lm.init_params(cfg, seed=7, device="cpu"), **ELASTIC)
        out[shape] = {"restored_from": run["restored_from"], "losses": run["losses"]}
    if rank0():
        # the step-2 state restored on the host, saved by the one-device path
        from repro_torch.checkpoint.manager import restore_checkpoint
        model = lm.init_params(cfg, seed=0, device="cpu")
        opt_state = adamw(LR).init(dict(model.named_parameters()))
        state, step = restore_checkpoint(first, train.state_tree(model, opt_state), step=2)
        train.load_state(model, opt_state, state)
        save_checkpoint(os.path.join(ckpt_root, "plain"), train.state_tree(model, opt_state),
                        step)
    return out


# ------------------------------------------------------ tensor parallelism
def tp_config(arch, tp_block="shard_map"):
    return dataclasses.replace(get_config(arch, reduced=True), tp_block=tp_block)


def tp_batch(cfg, batch: int = 4, seed: int = 0):
    """SMOKE ``train_4k`` rows, every position counted (the reference's
    ``test_tp_shard_map_equals_gspmd`` batch)."""
    shape = dataclasses.replace(SMOKE_SHAPES["train_4k"], batch=batch)
    return make_batch(cfg, shape, seed=seed, device="cpu")["batch"]


def tp_gradients(arch, shape=None, weights=None):
    """(loss, {name: gradient}) of reduced ``arch`` with
    ``tp_block="shard_map"`` on :func:`tp_batch`, from ``weights``: over a
    mesh of ``shape`` through the train step's gradient path (rank 0's
    gradients; the loss of every rank), or without one on one device (the
    replicated model)."""
    model = lm.LM(tp_config(arch), device="cpu")
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(weights[n])
    b = tp_batch(model.cfg)
    if shape is None:
        metrics, grads = steps._grads(model, b)
    else:
        metrics, grads = steps.mesh_gradients(model, b, mesh_of(shape))
    keep = shape is None or rank0()
    return (float(metrics["loss"].detach()),
            {n: g.clone() for n, g in grads.items()} if keep else None)


def tp_cases(cases):
    return {key: tp_gradients(arch, shape, weights) for key, arch, shape, weights in cases}


# ------------------------------------------------------ expert parallelism
def moe_sharded(params, x, shape, capacity_factor, top_k, cotangent=None, repeats=1):
    """``moe_apply_sharded`` of ``x`` (B, S, D) on a mesh of ``shape``:
    each rank's rows (dim 0 split over ``data``), the outputs of
    ``repeats`` calls, the aux, and with ``cotangent`` (the global
    batch's) the gradients of ``<out, cotangent> + aux`` — the experts'
    summed over ``model`` as the step sums them, x's this rank's rows."""
    import torch.distributed as dist

    from repro_torch.layers.moe import moe_apply_sharded
    mesh = mesh_of(shape)
    data = mesh.get_local_rank("data")
    rows = x.chunk(shape[0], dim=0)[data]
    p = {n: t.clone().requires_grad_(cotangent is not None) for n, t in params.items()}
    xr = rows.clone().requires_grad_(cotangent is not None)
    kw = dict(top_k=top_k, capacity_factor=capacity_factor, model_group=mesh.get_group("model"),
              data_group=mesh.get_group("data"))
    outs = [moe_apply_sharded(p, xr, **kw) for _ in range(repeats)]
    out, aux = outs[0]
    res = {"data": data, "outs": [o.detach() for o, _ in outs], "aux": float(aux)}
    if cotangent is not None:
        ((out * cotangent.chunk(shape[0], dim=0)[data]).sum() + aux).backward()
        grads = {n: t.grad for n, t in p.items()}
        for n in ("w_gate", "w_up", "w_down"):
            dist.all_reduce(grads[n], group=mesh.get_group("model"))
        res["grads"] = grads
        res["x_grad"] = xr.grad
    return res




def call_all(calls):
    """``{key: fn(*args, **kwargs)}`` of every (key, fn, args, kwargs) in
    ``calls``, on every rank."""
    return {key: fn(*args, **kw) for key, fn, args, kw in calls}
