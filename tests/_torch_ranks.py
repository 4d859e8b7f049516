"""Multi-process rank programs of the port's data-parallel tests.

``run_ranks(world, program, tmp_path, **kwargs)`` starts ``world`` fresh
interpreters (``python -m tests._torch_ranks <program> <dir>``) on the CPU
(``DS_ACCELERATOR=cpu``, gloo), joined through a ``file://`` store in the
test's own temporary directory (no port is ever bound), each with one
thread.  Each rank runs ``PROGRAMS[program](**kwargs)`` and saves what it
returns; the parent loads every rank's result.  The ranks are joined with
one deadline (``timeout``): a hung collective fails its test, it does not
eat the suite's time limit.  This module imports no jax, and each rank
checks at the end that nothing it ran did.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time
import uuid
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
S = 16
VOCAB = 256


# ---------------------------------------------------------------------------
# The parent's side
# ---------------------------------------------------------------------------

def run_ranks(world: int, program: str, tmp_path, timeout: float = 120.0, **kwargs):
    """Run ``program`` on ``world`` gloo ranks; returns their results in rank
    order (raises with the ranks' output on a failure or the deadline)."""
    tmp = Path(tmp_path) / f"{program}-w{world}-{uuid.uuid4().hex[:8]}"
    tmp.mkdir(parents=True)
    torch.save(kwargs, tmp / "args.pt")
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "LOCAL_WORLD_SIZE")}
    env.update(DS_ACCELERATOR="cpu", OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT), env.get("PYTHONPATH", "")]),
               WORLD_SIZE=str(world))
    procs, logs = [], []
    for r in range(world):
        log = open(tmp / f"rank{r}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tests._torch_ranks", program, str(tmp)],
            cwd=str(ROOT), env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
            stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        raise AssertionError(f"{program} on {world} ranks passed its {timeout:.0f} s "
                             f"deadline\n{_tails(tmp, world)}")
    finally:
        for log in logs:
            log.close()
    if any(p.returncode for p in procs):
        raise AssertionError(f"{program} on {world} ranks failed (exit codes "
                             f"{[p.returncode for p in procs]})\n{_tails(tmp, world)}")
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _tails(tmp: Path, world: int) -> str:
    out = []
    for r in range(world):
        text = (tmp / f"rank{r}.log").read_text(errors="replace")
        out.append(f"--- rank {r} ---\n{text[-4000:]}")
    return "\n".join(out)


# ---------------------------------------------------------------------------
# Data shared by the parent and the ranks
# ---------------------------------------------------------------------------

def make_batches(n: int, rows: int, seed: int = 1, ignore: bool = True):
    """``n`` global batches of ``rows`` rows: tokens, and labels (the
    next-token shift) with -100 at a different count of positions in each
    row, so that the ranks of a data-parallel run hold unequal counts of
    labelled tokens."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rs.randint(0, VOCAB, (rows, S)).astype(np.int64)
        labels = np.concatenate([ids[:, 1:], np.full((rows, 1), -100)], 1)
        if ignore:
            for r in range(rows):
                k = (3 * r + rs.randint(0, 3)) % (S - 2)
                labels[r, rs.choice(S - 1, k, replace=False)] = -100
        out.append({"input_ids": ids, "labels": labels})
    return out


# ---------------------------------------------------------------------------
# Rank programs
# ---------------------------------------------------------------------------

def _group_of(layout, axes, rank):
    from deepspeed_tpu_torch.parallel.mesh import (MESH_AXES, ProcessTopology,
                                                   canonical_axes)

    topo = ProcessTopology(MESH_AXES, layout.axis_sizes())
    for ranks in topo.get_axes_comm_lists(canonical_axes(axes)):
        if rank in ranks:
            return ranks


def prog_comm(layout: dict, axes_list: list):
    """Every facade op over every axis of ``axes_list``; returns
    ``[(name, got, want), ...]`` and the comms logger's totals."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.parallel.mesh import MeshLayout, initialize_mesh

    lay = MeshLayout(**layout)
    initialize_mesh(lay)
    comm.configure({"enabled": True})
    rank = comm.get_rank()

    def inp(r, shape=(4, 8)):
        return np.arange(np.prod(shape), dtype=np.float32).reshape(shape) + 100 * r

    out, expect_calls, expect_bytes = [], {}, {}

    def log(op, nbytes):
        expect_calls[op] = expect_calls.get(op, 0) + 1
        expect_bytes[op] = expect_bytes.get(op, 0) + nbytes

    for axes in axes_list:
        group = _group_of(lay, axes, rank)
        n, idx = len(group), group.index(rank)
        x = torch.from_numpy(inp(rank))
        name = "/".join([axes] if isinstance(axes, str) else axes)
        out.append((f"{name} axis_index", comm.axis_index(axes), idx))
        out.append((f"{name} axis_size", comm.get_axis_size(axes), n))
        out.append((f"{name} all_reduce sum", comm.all_reduce(x, comm.SUM, axes),
                    sum(inp(q) for q in group)))
        out.append((f"{name} all_reduce max", comm.all_reduce(x, comm.MAX, axes),
                    inp(max(group))))
        out.append((f"{name} all_reduce avg", comm.all_reduce(x, comm.AVG, axes),
                    sum(inp(q) for q in group) / n))
        for _ in range(3):
            log("all_reduce", x.numel() * 4)
        for d in (0, 1):
            out.append((f"{name} all_gather dim {d}", comm.all_gather(x, axes, d),
                        np.concatenate([inp(q) for q in group], axis=d)))
            out.append((f"{name} reduce_scatter dim {d}",
                        comm.reduce_scatter(x, axes, d),
                        np.split(sum(inp(q) for q in group), n, axis=d)[idx]))
            log("all_gather", x.numel() * 4)
            log("reduce_scatter", x.numel() * 4)
        out.append((f"{name} all_to_all 0->1", comm.all_to_all(x, axes, 0, 1),
                    np.concatenate([np.split(inp(q), n, axis=0)[idx] for q in group],
                                   axis=1)))
        out.append((f"{name} send_recv_next", comm.send_recv_next(x, axes),
                    inp(group[(idx - 1) % n])))
        out.append((f"{name} send_recv_prev", comm.send_recv_prev(x, axes),
                    inp(group[(idx + 1) % n])))
        out.append((f"{name} ppermute 0->last", comm.ppermute(x, axes, [(0, n - 1)]),
                    inp(group[0]) if idx == n - 1 else np.zeros_like(inp(0))))
        out.append((f"{name} broadcast", comm.broadcast(x, 0, axes), inp(group[0])))
        for op in ("all_to_all", "ppermute", "ppermute", "ppermute", "broadcast"):
            log(op, x.numel() * 4)
    out = [(k, np.asarray(g), np.asarray(w)) for k, g, w in out]
    totals = comm.get_comms_logger().totals()
    from deepspeed_tpu_torch.comm.benchmark import BUSBW_FACTOR, run_sweep

    bench = run_sweep(list(BUSBW_FACTOR), 12, 12, trials=2, print_table=False,
                      device="cpu")
    table = comm.log_summary(show_bandwidth=True, print_log=False)
    return {"checks": out, "totals": totals, "bench": bench, "table": table,
            "expect": {op: {"calls": expect_calls[op], "bytes": expect_bytes[op]}
                       for op in expect_calls}}


def _flat(tree, prefix=""):
    from deepspeed_tpu_torch.utils.tree import tree_flatten_with_path

    return {p: x for p, x in tree_flatten_with_path(tree)}


def _engine(case: dict, params_np):
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import CausalLM
    from deepspeed_tpu_torch.models.convert import params_from_jax

    dtype = getattr(torch, case.get("dtype", "float64"))
    model = CausalLM(case.get("model", "tiny"), dtype=dtype, **case.get("model_kw", {}))
    params = params_from_jax(params_np, device="cpu")
    if dtype == torch.float64:
        from deepspeed_tpu_torch.utils.tree import tree_map

        params = tree_map(lambda x: x.double(), params)
    loss_fn = None
    if case.get("plant_inf"):
        def loss_fn(p, batch, gen):
            loss = model.loss_fn(p, {"input_ids": batch["input_ids"],
                                     "labels": batch["labels"]}, gen)
            # the same graph on every rank (the gathers' reduce-scatters run
            # in the backward's order); an inf only where this rank's rows
            # are planted
            inf = torch.where(batch["plant"].any(), float("inf"), 0.0)
            return loss + p["embed"][0, 0].float() * inf
    mesh = None
    if case.get("mesh"):
        from deepspeed_tpu_torch.parallel.mesh import MeshLayout

        mesh = MeshLayout(**case["mesh"])
    engine, *_ = ds.initialize(model=model, loss_fn=loss_fn, config=case["config"],
                               device="cpu", params=params, mesh=mesh)
    return engine


def _full(engine, fp32: bool = True) -> dict:
    """The whole parameter tree (ZeRO and model-axis shards gathered), on
    the host, by path (collective)."""
    from deepspeed_tpu_torch import zero
    from deepspeed_tpu_torch.parallel.tensor_parallel import gather_tree

    with zero.GatheredParameters(engine.get_params(fp32=fp32), to_device=True) as g:
        tree = g.values
    if engine.tp:
        tree = gather_tree(tree, engine._tp_specs)
    return {k: v.detach().float().numpy() if v.dtype == torch.bfloat16
            else v.detach().numpy() for k, v in _flat(tree).items()}


def _shapes(tree) -> dict:
    return {p: tuple(x.shape) for p, x in _flat(tree).items()}


def _moments(engine) -> dict:
    """Local shapes of the Adam moments (``mu``), by parameter path."""
    from deepspeed_tpu_torch.runtime.optimizer import ScaleByAdamState

    def find(state):
        if isinstance(state, ScaleByAdamState):
            return state
        if isinstance(state, tuple):
            for s in state:
                hit = find(s)
                if hit is not None:
                    return hit
        return None

    return _shapes(find(engine.state.opt_state).mu)


def _run_case(case: dict, params_np, batches):
    from deepspeed_tpu_torch import comm, zero

    engine = _engine(case, params_np)
    losses, norms, scales, sums = [], [], [], []
    for b in batches:
        if case.get("loop"):   # forward/backward/step over the gas micro-batches
            rows = len(b["input_ids"]) // engine.gas
            for i in range(engine.gas):
                engine.backward(engine.forward({k: v[i * rows:(i + 1) * rows]
                                                 for k, v in b.items()}))
            losses.append(float(engine.step()["loss"]))
        else:
            losses.append(float(engine.train_batch(batch=b)))
        norms.append(engine.get_global_grad_norm())
        scales.append(engine.loss_scale)
        masters = (engine.state.master_params if engine.state.master_params is not None
                   else engine.state.params)
        sums.append([float(x.double().sum()) for x in _flat(masters).values()])
    masters = _full(engine)
    with zero.GatheredParameters(engine.get_params(), to_device=True) as g:
        params_full = {k: v.clone() for k, v in _flat(g.values).items()}
    local_master = {k: v.detach().clone()
                    for k, v in _flat(engine.state.master_params
                                      if engine.state.master_params is not None
                                      else engine.state.params).items()}
    out = {"losses": losses, "grad_norms": norms, "loss_scales": scales,
           "local_master_sums": sums,
           "masters": masters, "params_full_shapes": _shapes(params_full),
           "param_shapes": _shapes(engine.state.params),
           "master_shapes": {k: tuple(v.shape) for k, v in local_master.items()},
           "local_masters": {k: v.numpy() for k, v in local_master.items()},
           "moment_shapes": _moments(engine),
           "skipped": engine.skipped_steps, "dp_world": engine.dp_world,
           "rank": comm.get_rank(), "axis_data": comm.axis_index("data"),
           "tp": engine.tp, "axis_model": comm.axis_index("model"),
           "axis_data_outer": comm.axis_index("data_outer")}
    del engine
    return out


def prog_train(cases: list, params_np, batches):
    """Each case: an engine trained on ``batches``; losses, norms, the
    gathered masters and the local shapes of every kind of state."""
    return [_run_case(case, params_np, batches) for case in cases]


def prog_checkpoint(config: dict, params_np, batches, ckpt_dir: str, mode: str,
                    async_save: bool = False, dtype: str = "bfloat16",
                    mesh: dict = None, model: str = "tiny"):
    """``save``: 2 steps, a save, 2 more steps (the run that never stopped);
    ``resume``: a fresh engine loads and runs the last 2 steps; ``load``: a
    fresh engine loads; each returns losses and gathered masters (``mesh``:
    the engine's ``MeshLayout`` keywords, a model axis included)."""
    cfg = {**config, "checkpoint": {"async_save": async_save}}
    engine = _engine({"config": cfg, "dtype": dtype, "mesh": mesh, "model": model},
                     params_np)
    losses = []
    if mode == "save":
        for b in batches[:2]:
            losses.append(float(engine.train_batch(batch=b)))
        engine.save_checkpoint(ckpt_dir)
        engine.wait_for_checkpoint()
        saved = _full(engine)
        for b in batches[2:]:
            losses.append(float(engine.train_batch(batch=b)))
    else:
        engine.load_checkpoint(ckpt_dir)
        saved = _full(engine)
        if mode == "resume":
            for b in batches[2:]:
                losses.append(float(engine.train_batch(batch=b)))
    final = _full(engine)
    return {"losses": losses, "saved": saved, "final": final,
            "steps": engine.global_steps}


def prog_tiling(seed: int, cases: list):
    """``tiled_linear`` on a ZeRO shard of the weight (each tile gathered on
    its own) against the plain product, value and gradient."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.parallel.mesh import ZERO_AXES, MeshLayout, initialize_mesh
    from deepspeed_tpu_torch.runtime.zero.tiling import tiled_linear

    world = comm.get_world_size()
    initialize_mesh(MeshLayout(dp=world))
    n, i = comm.get_axis_size(ZERO_AXES), comm.axis_index(ZERO_AXES)
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(3, 5, 16, generator=g)
    w = torch.randn(16, 24, generator=g)
    dy = torch.randn(3, 5, 24, generator=g)
    ref = x @ w
    ref_dw = torch.einsum("bsi,bso->io", x, dy) * world   # every rank's dy
    out = []
    for dim, out_splits, in_splits in cases:
        shard = w.chunk(n, dim)[i].clone().requires_grad_()
        y = tiled_linear(x, shard, out_splits=out_splits, in_splits=in_splits,
                         shard_dim=dim)
        (y * dy).sum().backward()
        out.append({"case": (dim, out_splits, in_splits),
                    "err": float((y - ref).abs().max()),
                    "grad_err": float((shard.grad - ref_dw.chunk(n, dim)[i]).abs().max())})
    return out


def _requests(stream):
    from deepspeed_tpu_torch.inference import Request
    from deepspeed_tpu_torch.inference.sampling import SamplingParams

    return [Request(rid=r["rid"], input_ids=np.asarray(r["ids"], np.int32),
                    max_new_tokens=r["max_new"], deadline_s=r.get("deadline_s"),
                    arrival_time=r.get("arrival", 0.0),
                    sampling=(SamplingParams(**r["sampling"]) if r.get("sampling")
                              else None))
            for r in stream]


def prog_serve(model: str, params_np, tp: int, tokens, prompts, max_new: int,
               stream, deadline_stream, serve_kw: dict, lanes: list):
    """Tensor-parallel inference and paged serving on ``tp`` of the ranks'
    model axis (``initialize_serving_mesh``): fp32 ``forward`` logits,
    ``generate`` greedy and on sampled lanes, a serving run of ``stream``
    (greedy and sampled requests), one of ``deadline_stream`` whose
    deadlines expire mid-run, health and page accounting."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.inference.sampling import SamplingParams
    from deepspeed_tpu_torch.models import CausalLM
    from deepspeed_tpu_torch.models.convert import params_from_jax
    from deepspeed_tpu_torch.parallel.mesh import initialize_serving_mesh

    m = CausalLM(model, dtype=torch.float32)
    mesh = initialize_serving_mesh(tp=tp)
    eng = ds.init_inference(m, config={"dtype": "float32"},
                            params=params_from_jax(params_np, device="cpu"),
                            mesh=mesh, device="cpu")
    from deepspeed_tpu_torch import comm

    comm.configure({"enabled": True})
    logits = eng.forward(torch.as_tensor(tokens)).numpy()
    out = {"local_shapes": _shapes(eng.params), "logits": logits,
           "forward_collectives": comm.get_comms_logger().totals_by_axis(),
           "greedy": eng.generate(prompts, max_new_tokens=max_new).numpy(),
           "sampled": eng.generate(prompts, max_new_tokens=max_new,
                                   sampling=[SamplingParams(**lp) for lp in lanes]
                                   ).numpy()}
    sv = eng.serving(**serve_kw)
    res = sv.run(_requests(stream))
    out["served"] = {r.rid: (r.output_ids, r.finish_reason) for r in res}
    out["health"] = sv.health()
    out["balanced"] = sv.page_accounting()["balanced"]
    out["inventory"] = sv.program_inventory()
    res = sv.run(_requests(deadline_stream))
    out["deadline"] = {r.rid: (r.output_ids, r.finish_reason) for r in res}
    out["balanced_after_deadlines"] = sv.page_accounting()["balanced"]
    sv.close()   # every rank, before the group's teardown
    out["refusals"] = {}
    tree = params_from_jax(params_np, device="cpu")
    for what, call in (
            ("init_inference(apply_fn=)", lambda: ds.init_inference(
                apply_fn=lambda p, x: x, params=tree, mesh=mesh, device="cpu")),
            ("initialize(loss_fn=)", lambda: ds.initialize(
                loss_fn=lambda p, b, g: p["embed"].sum(), params=tree, mesh=mesh,
                config={"train_batch_size": 1}, device="cpu"))):
        try:
            call()
            out["refusals"][what] = "accepted"
        except NotImplementedError as e:
            out["refusals"][what] = str(e)
    try:   # the serving mesh spans the process group
        initialize_serving_mesh(tp=1, n_devices=1)
        out["n_devices_error"] = None
    except ValueError as e:
        out["n_devices_error"] = str(e)
    return out


PROGRAMS = {"comm": prog_comm, "train": prog_train, "checkpoint": prog_checkpoint,
            "tiling": prog_tiling, "serve": prog_serve}


def main() -> int:
    program, tmp = sys.argv[1], Path(sys.argv[2])
    torch.set_num_threads(1)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    from deepspeed_tpu_torch import comm

    comm.init_distributed(init_method=f"file://{tmp}/store", rank=rank,
                          world_size=world, timeout=100, verbose=False)
    kwargs = torch.load(tmp / "args.pt", weights_only=False)
    result = PROGRAMS[program](**kwargs)
    assert "jax" not in sys.modules, "a rank program imported jax"
    torch.save(result, tmp / f"rank{rank}.pt")
    comm.barrier()
    comm.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
