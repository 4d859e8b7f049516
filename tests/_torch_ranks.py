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

def make_batches(n: int, rows: int, seed: int = 1, ignore: bool = True,
                 seq: int = S, vocab: int = VOCAB):
    """``n`` global batches of ``rows`` rows of ``seq`` tokens: tokens, and
    labels (the next-token shift) with -100 at a different count of
    positions in each row, so that the ranks of a data-parallel run hold
    unequal counts of labelled tokens."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rs.randint(0, vocab, (rows, seq)).astype(np.int64)
        labels = np.concatenate([ids[:, 1:], np.full((rows, 1), -100)], 1)
        if ignore:
            for r in range(rows):
                k = (3 * r + rs.randint(0, 3)) % (min(seq, S) - 2)
                labels[r, rs.choice(seq - 1, k, replace=False)] = -100
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


class SimpleTPModel:
    """The JAX tests' ``SimpleTPModel`` (``tests/unit/simple_model.py``):
    an MLP of ``nlayers`` tanh layers and a scalar head, MSE loss, its
    even layers column-parallel and odd ones row-parallel over 'model'."""

    def __init__(self, hidden_dim: int = 16, nlayers: int = 2, specs: bool = True):
        self.hidden_dim, self.nlayers = hidden_dim, nlayers
        if specs:
            self.param_specs = {
                **{f"linear_{i}": ({"kernel": (None, "model"), "bias": ("model",)}
                                   if i % 2 == 0 else
                                   {"kernel": ("model", None), "bias": ()})
                   for i in range(nlayers)},
                "head": {"kernel": ()}}

    def init_fn(self, gen):
        d = self.hidden_dim
        p = {f"linear_{i}": {"kernel": torch.randn(d, d, generator=gen,
                                                   dtype=torch.float64) * 0.1,
                             "bias": torch.zeros(d, dtype=torch.float64)}
             for i in range(self.nlayers)}
        p["head"] = {"kernel": torch.randn(d, 1, generator=gen, dtype=torch.float64) * 0.1}
        return p

    def loss_fn(self, params, batch, gen):
        h = batch["x"]
        for i in range(self.nlayers):
            layer = params[f"linear_{i}"]
            h = torch.tanh(h @ layer["kernel"] + layer["bias"])
        pred = (h @ params["head"]["kernel"]).squeeze(-1)
        return ((pred - batch["y"]) ** 2).mean()


def simple_batch(rows: int, hidden: int, seed: int) -> dict:
    """The JAX tests' ``random_batch``: x, and y from fixed teacher weights."""
    x = np.random.RandomState(seed).randn(rows, hidden)
    w = np.random.RandomState(1234).randn(hidden)
    return {"x": x, "y": x @ w * 0.1}


def _engine(case: dict, params_np):
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import CausalLM
    from deepspeed_tpu_torch.models.convert import params_from_jax

    mesh = None
    if case.get("mesh"):
        from deepspeed_tpu_torch.parallel.mesh import MeshLayout

        mesh = MeshLayout(**case["mesh"])
    if case.get("generic"):   # a bare loss_fn tree (SimpleTPModel)
        model = SimpleTPModel(specs=case["generic"] == "specs")
        gen = torch.Generator().manual_seed(case.get("seed", 0))
        engine, *_ = ds.initialize(model=model, config=case["config"], device="cpu",
                                   mesh=mesh, params=model.init_fn(gen))
        return engine
    dtype = getattr(torch, case.get("dtype", "float64"))
    model = CausalLM(case.get("model", "tiny"), dtype=dtype, **case.get("model_kw", {}))
    if case.get("no_params"):   # the engine draws the seed's weights
        engine, *_ = ds.initialize(model=model, config=case["config"], device="cpu",
                                   mesh=mesh)
        return engine
    params = params_from_jax(case.get("params_np", params_np), device="cpu")
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
    engine, *_ = ds.initialize(model=model, loss_fn=loss_fn, config=case["config"],
                               device="cpu", params=params, mesh=mesh)
    return engine


def _full(engine, fp32: bool = True) -> dict:
    """The whole parameter tree (ZeRO and model-axis shards gathered, the
    padding of uneven ones cut), on the host, by path (collective)."""
    tree = engine.full_params(fp32=fp32)
    return {k: v.detach().float().numpy() if v.dtype == torch.bfloat16
            else v.detach().numpy() for k, v in _flat(tree).items()}


def _shapes(tree) -> dict:
    return {p: tuple(x.shape) for p, x in _flat(tree).items()}


def _adam(engine):
    """The Adam state (``mu``, ``nu``) of the engine's optimizer chain."""
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

    return find(engine.state.opt_state)


def _moments(engine) -> dict:
    """Local shapes of the Adam moments (``mu``), by parameter path (none
    for an optimizer without them)."""
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

    adam = find(engine.state.opt_state)
    return _shapes(adam.mu) if adam is not None else {}


def _run_case(case: dict, params_np, batches):
    from deepspeed_tpu_torch import comm, zero
    from deepspeed_tpu_torch.ops.ring_attention import ring_attention

    engine = _engine(case, params_np)
    batches = case.get("batches", batches)
    init_masters = _full(engine) if case.get("no_params") else None
    ring_attention.rotations = 0
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
    tp_shards = moments = None
    if engine.tp and not engine._generic_tp:   # padded model-axis shards
        with zero.GatheredParameters(engine.get_params(fp32=True), to_device=True) as g:
            tp_shards = {k: v.detach().numpy() for k, v in _flat(g.values).items()}
        if engine.partition is None or engine.zero_stage == 0:
            mu_nu = _adam(engine)
            moments = {w: {k: v.detach().numpy() for k, v in _flat(getattr(mu_nu, w)).items()}
                       for w in ("mu", "nu")}
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
           "axis_data_outer": comm.axis_index("data_outer"),
           "sp": engine.sp, "axis_seq": comm.axis_index("seq"),
           "ring_rotations": ring_attention.rotations, "init_masters": init_masters,
           "tp_shards": tp_shards, "moments": moments}
    del engine
    return out


def prog_train(cases: list, params_np, batches):
    """Each case: an engine trained on ``batches``; losses, norms, the
    gathered masters and the local shapes of every kind of state."""
    return [_run_case(case, params_np, batches) for case in cases]


def prog_checkpoint(config: dict, params_np, batches, ckpt_dir: str, mode: str,
                    async_save: bool = False, dtype: str = "bfloat16",
                    mesh: dict = None, model: str = "tiny", model_kw: dict = None):
    """``save``: 2 steps, a save, 2 more steps (the run that never stopped);
    ``resume``: a fresh engine loads and runs the last 2 steps; ``load``: a
    fresh engine loads; each returns losses and gathered masters (``mesh``:
    the engine's ``MeshLayout`` keywords, a model axis included)."""
    cfg = {**config, "checkpoint": {"async_save": async_save}}
    engine = _engine({"config": cfg, "dtype": dtype, "mesh": mesh, "model": model,
                      "model_kw": model_kw or {}}, params_np)
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
    return out


def prog_serve_extras(model: str, params_np, draft_np, loras: dict, tp: int,
                      stream, serve_kw: dict, fuse: str):
    """The paged serving extras together on ``tp`` ranks of a serving mesh
    (``tp=1``: one process, no mesh): int8 pages, a host tier, speculative
    decoding and per-slot adapters in one engine over ``stream``
    (``{"rid", "ids", "max_new", "adapter"}``), then ``fuse`` served from
    fused weights.  Returns the served tokens, the tier's movements, the
    speculative acceptance, the int8 scale planes and the accounting."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.inference import (AdapterRegistry, Request,
                                               SpeculativeConfig)
    from deepspeed_tpu_torch.models import CausalLM
    from deepspeed_tpu_torch.models.convert import params_from_jax
    from deepspeed_tpu_torch.parallel.mesh import initialize_serving_mesh
    from deepspeed_tpu_torch.runtime.lora import LoRAConfig

    m = CausalLM(model, dtype=torch.float32, attn_impl="xla")
    params = params_from_jax(params_np, device="cpu")
    mesh = initialize_serving_mesh(tp=tp) if tp > 1 else None
    eng = ds.init_inference(m, config={"dtype": "float32"}, params=params,
                            mesh=mesh, device="cpu")
    reg = AdapterRegistry(params["layers"])
    for aid, (rank, lora) in sorted(loras.items()):
        reg.register(aid, lora, LoRAConfig(rank=rank, alpha=2.0 * rank))
    spec = SpeculativeConfig(CausalLM(model, dtype=torch.float32, attn_impl="xla"),
                             params_from_jax(draft_np, device="cpu"), k=3)
    sv = eng.serving(kv_dtype="int8", host_tier_pages=16, speculative=spec,
                     adapters=reg, **serve_kw)

    def reqs(items, tag=""):
        return [Request(rid=f"{tag}{r['rid']}", input_ids=np.asarray(r["ids"], np.int32),
                        max_new_tokens=r["max_new"], adapter_id=r["adapter"])
                for r in items]

    served = {r.rid: r.output_ids for r in sv.run(reqs(stream))}
    h = sv.health()
    out = {"served": served, "balanced": sv.page_accounting()["balanced"],
           "k_scale": sv._exec.pools[2].clone(), "v_scale": sv._exec.pools[3].clone(),
           "draft_k_scale": sv._spec.dpools[2].clone(),
           **{k: h[k] for k in ("demotions_total", "promotions_total",
                                "spec_emitted_tokens_total", "spec_verify_slot_ticks_total",
                                "adapter_admissions_total", "prefix_hits_total")}}
    sv.fuse_adapter(fuse)
    mine = [r for r in stream if r["adapter"] == fuse]
    out["fused"] = {r.rid: r.output_ids for r in sv.run(reqs(mine, tag="f"))}
    sv.fuse_adapter(None)
    out["balanced_after_fuse"] = sv.page_accounting()["balanced"]
    sv.close()   # every rank, before the group's teardown
    return out


def prog_ring(cases: list, q, k, v):
    """Ring attention on this rank's rows and sequence slice of the global
    q/k/v (fp64): each case ``{"sp", "causal", "impl"[, "qkv"]}`` on a mesh of
    ``world/sp`` data x ``sp`` seq ranks; returns the local output, the
    gradients of the global sum of squares, and the slices."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.ops.ring_attention import ring_attention
    from deepspeed_tpu_torch.parallel.mesh import MeshLayout, initialize_mesh

    out = []
    for case in cases:
        q, k, v = case.get("qkv", (q, k, v))
        sp = case["sp"]
        initialize_mesh(MeshLayout(dp=comm.get_world_size() // sp, sp=sp))
        dp, d = comm.get_axis_size(("data", "expert")), comm.axis_index(("data", "expert"))
        n, i = comm.get_axis_size("seq"), comm.axis_index("seq")
        B, Sg = q.shape[:2]
        rows = slice(d * B // dp, (d + 1) * B // dp)
        cols = slice(i * Sg // n, (i + 1) * Sg // n)
        qt, kt, vt = (torch.from_numpy(np.ascontiguousarray(x[rows, cols])).requires_grad_()
                      for x in (q, k, v))
        before = ring_attention.rotations
        o = ring_attention(qt, kt, vt, causal=case["causal"], impl=case["impl"])
        (o ** 2).sum().backward()
        out.append({"rows": (rows.start, rows.stop), "cols": (cols.start, cols.stop),
                    "out": o.detach().numpy(), "dq": qt.grad.numpy(),
                    "dk": kt.grad.numpy(), "dv": vt.grad.numpy(),
                    "rotations": ring_attention.rotations - before})
    return out


def prog_routing(model: str, seq: int):
    """``_attention``'s routing errors on meshes of this world (JAX's
    conditions and messages), by case name."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models import transformer as ttf
    from deepspeed_tpu_torch.parallel.mesh import MeshLayout, initialize_mesh, reset_mesh

    world = comm.get_world_size()
    errs = {}

    def attempt(name, layout, impl, **kw):
        initialize_mesh(layout)
        cfg = ttf.get_config(model, dtype=torch.float64, **kw.pop("cfg", {}))
        hq, hkv, hd = cfg.num_heads, cfg.kv_heads, cfg.dims_per_head
        x = torch.zeros(1, seq // layout.sp, hq // layout.tp, hd, dtype=torch.float64)
        kv = torch.zeros(1, seq // layout.sp, max(hkv // layout.tp, 1), hd,
                         dtype=torch.float64)
        pos = torch.arange(seq // layout.sp)[None]
        try:
            ttf._attention(cfg, x, kv, kv, pos, impl, **kw)
            errs[name] = None
        except ValueError as e:
            errs[name] = str(e)
        reset_mesh()

    attempt("ulysses_heads", MeshLayout(sp=world), "ulysses", cfg={"num_kv_heads": 2,
                                                                   "num_heads": 8})
    attempt("ulysses_pipe", MeshLayout(pp=2, sp=world // 2), "ulysses")
    attempt("ulysses_positions", MeshLayout(sp=world), "ulysses", custom_positions=True)
    attempt("ring_heads", MeshLayout(tp=2, sp=world // 2), "ring",
            cfg={"num_heads": 3, "num_kv_heads": 3, "hidden_size": 48})
    attempt("ring_alibi", MeshLayout(sp=world), "ring", cfg={"position": "alibi"})
    attempt("ring_ok", MeshLayout(sp=world), "ring")
    attempt("ulysses_ok", MeshLayout(sp=world), "ulysses")
    return errs


def prog_generate(cases: list):
    """Tensor-parallel ``forward`` logits and greedy ``generate`` tokens
    (fp32, ``initialize_serving_mesh``) for each case ``{"model",
    "model_kw", "params_np", "tp", "tokens", "prompts", "max_new"}``, with
    the local shapes the engine holds."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import CausalLM
    from deepspeed_tpu_torch.models.convert import params_from_jax
    from deepspeed_tpu_torch.parallel.mesh import initialize_serving_mesh

    out = []
    for case in cases:
        m = CausalLM(case["model"], dtype=torch.float32, **case.get("model_kw", {}))
        mesh = initialize_serving_mesh(tp=case["tp"])
        eng = ds.init_inference(m, config={"dtype": "float32"},
                                params=params_from_jax(case["params_np"], device="cpu"),
                                mesh=mesh, device="cpu")
        out.append({"logits": eng.forward(torch.as_tensor(case["tokens"])).numpy(),
                    "greedy": eng.generate(case["prompts"],
                                           max_new_tokens=case["max_new"]).numpy(),
                    "local_shapes": _shapes(eng.params)})
    return out


def tiny_lm_params(vocab: int = 32, dim: int = 16, seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"embed": torch.randn(vocab, dim, generator=g, dtype=torch.float64) * 0.1,
            "out": torch.randn(dim, vocab, generator=g, dtype=torch.float64) * 0.1}


def tiny_lm_apply(p, ids):
    """The JAX tests' ``tiny_lm``: an embedding and an output matrix."""
    return p["embed"][ids] @ p["out"]


def prog_generic(config: dict, steps: int, rows: int, hidden: int, tp: int):
    """A bare ``apply_fn``/``loss_fn`` tree at a model axis of ``tp``: the
    JAX contracts (a column-parallel ``linear_0`` of local shape
    ``[.., n/tp]`` and a falling loss over ``steps`` steps; the tp=2
    forward of ``tiny_lm``), the losses and gathered masters for the
    parent's one-process run, and a flash call on DTensors refused."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.ops.kernels.flash_attention import flash_attention
    from deepspeed_tpu_torch.parallel import tensor_parallel
    from deepspeed_tpu_torch.parallel.mesh import MeshLayout, initialize_serving_mesh

    model = SimpleTPModel(hidden)
    eng, *_ = ds.initialize(model=model, config=config, device="cpu",
                            mesh=MeshLayout(tp=tp))
    out = {"local_kernel": tuple(eng.state.params["linear_0"]["kernel"].shape),
           "local_row": tuple(eng.state.params["linear_1"]["kernel"].shape),
           "losses": [float(eng.train_batch(batch=simple_batch(rows, hidden, s)))
                      for s in range(steps)]}
    out["masters"] = {k: v.numpy() for k, v in _flat(eng.full_params()).items()}
    mesh = initialize_serving_mesh(tp=tp)
    ie = ds.init_inference(apply_fn=tiny_lm_apply, params=tiny_lm_params(),
                           config={"dtype": "float32"}, mesh=mesh, device="cpu")
    out["logits"] = ie(np.array([[1, 2, 3]])).numpy()
    out["lm_local"] = _shapes(ie.params)
    x = tensor_parallel.as_dtensors(torch.zeros(1, 128, 2, 16))
    try:
        flash_attention(x, x, x)
        out["flash_dtensor"] = None
    except NotImplementedError as e:
        out["flash_dtensor"] = str(e)
    return out


def prog_subset(model: str, params_np, prompts, max_new: int):
    """``initialize_serving_mesh(n_devices=1)`` in a world of more: rank 0
    serves alone on its mesh, every other rank gets a handle that
    ``init_inference(mesh=)`` refuses naming it."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models import CausalLM
    from deepspeed_tpu_torch.models.convert import params_from_jax
    from deepspeed_tpu_torch.parallel.mesh import OutsideMesh, initialize_serving_mesh

    mesh = initialize_serving_mesh(tp=1, n_devices=1)
    m = CausalLM(model, dtype=torch.float32)
    params = params_from_jax(params_np, device="cpu")
    out = {"outside": isinstance(mesh, OutsideMesh), "rank": comm.get_rank()}
    try:
        eng = ds.init_inference(m, config={"dtype": "float32"}, params=params,
                                mesh=mesh, device="cpu")
        out["greedy"] = eng.generate(prompts, max_new_tokens=max_new).numpy()
        out["mesh_size"] = int(eng.mesh.size())
    except ValueError as e:
        out["error"] = str(e)
    comm.barrier()
    return out


def prog_sp_gate(model: str, layers: int, seq: int, steps: int, seed: int):
    """``chip_smoke.py``'s sequence-parallel configurations at CPU size: the
    model at ``layers`` layers and fp32, remat ``nothing_saveable``, the
    seed's own weights, one row of ``seq`` tokens from ``seed + 1``, ZeRO
    stage 0, on a 'seq' axis of the world (none at a world of one); its
    losses and global gradient norms over ``steps`` steps."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models import CausalLM
    from deepspeed_tpu_torch.parallel.mesh import MeshLayout

    world = comm.get_world_size()
    lm = CausalLM(model, dtype=torch.float32, num_layers=layers,
                  max_seq_len=seq, remat=True, remat_policy="nothing_saveable")
    config = {"train_micro_batch_size_per_gpu": 1, "gradient_accumulation_steps": 1,
              "optimizer": {"type": "adamw", "params": {"lr": 1e-4}},
              "zero_optimization": {"stage": 0}, "seed": seed,
              "steps_per_print": 10 ** 9}
    engine, *_ = ds.initialize(model=lm, config=config, device="cpu",
                               mesh=MeshLayout(sp=world) if world > 1 else None)
    gen = torch.Generator().manual_seed(seed + 1)
    batch = {"input_ids": torch.randint(0, lm.config.vocab_size, (1, seq), generator=gen)}
    losses, norms = [], []
    for _ in range(steps):
        losses.append(float(engine.train_batch(batch=batch)))
        norms.append(float(engine.get_global_grad_norm()))
    return {"losses": losses, "grad_norms": norms}


def prog_hf_load(path: str, tp: int, tokens, prompts, max_new: int):
    """``init_inference(<HF directory>, mesh=initialize_serving_mesh(tp))``:
    the rank's tree as loaded (it streams its own shards only), fp32
    logits and greedy tokens."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.parallel.mesh import initialize_serving_mesh
    from deepspeed_tpu_torch.utils.tree import tree_flatten_with_path

    eng = ds.init_inference(path, config={"dtype": "float32"},
                            mesh=initialize_serving_mesh(tp=tp), device="cpu")
    return {"params": dict(tree_flatten_with_path(eng.params)),
            "logits": eng.forward(torch.as_tensor(tokens)).numpy(),
            "greedy": eng.generate(prompts, max_new_tokens=max_new).numpy()}


def prog_quant_tp(model: str, tp: int):
    """Weight quantization on a model axis above 1 is refused (the JAX
    engine's tp=1 rule), through ``mesh=`` and through ``tp_size``."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import CausalLM
    from deepspeed_tpu_torch.parallel.mesh import initialize_serving_mesh

    m = CausalLM(model, dtype=torch.float32)
    params = m.init_fn(torch.Generator().manual_seed(0), device="cpu")
    out = {}
    for how, kw in (("mesh", {"mesh": initialize_serving_mesh(tp=tp)}),
                    ("tp_size", {"tensor_parallel": {"tp_size": tp}})):
        try:
            ds.init_inference(m, config={"dtype": "int8"}, params=params, device="cpu",
                              **kw)
        except NotImplementedError as e:
            out[how] = str(e)
    return out


def prog_multi(parts: list):
    """Several programs in one spawn, in order: ``[(name, kwargs), ...]``."""
    from deepspeed_tpu_torch.parallel.mesh import reset_mesh

    out = []
    for name, kwargs in parts:
        out.append(PROGRAMS[name](**kwargs))
        reset_mesh()
    return out


def prog_moe_infer(model: str, params_np, ep: int, tokens, prompts, max_new: int):
    """``init_inference`` with ``moe.ep_size``: each rank holds its experts
    of every MoE leaf; ``forward`` logits and greedy ``generate`` tokens
    (fp32), and the local shape of an expert leaf."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import CausalLM
    from deepspeed_tpu_torch.models.convert import params_from_jax

    eng = ds.init_inference(CausalLM(model, dtype=torch.float32),
                            config={"dtype": "float32", "moe": {"ep_size": ep}},
                            params=params_from_jax(params_np, device="cpu"), device="cpu")
    return {"logits": eng.forward(torch.as_tensor(tokens)).numpy(),
            "greedy": eng.generate(prompts, max_new_tokens=max_new).numpy(),
            "local_shapes": _shapes(eng.params)}


def megatron_moe_state_dict(L: int = 2, E: int = 4, d: int = 16, f: int = 32,
                            V: int = 64, seed: int = 0) -> tuple:
    """(config dict, state dict) of a tiny Megatron-DeepSpeed MoE GPT in its
    on-disk names and layouts (``tests/unit/test_module_inject.py``'s
    ``test_megatron_gpt_moe_structure``, with random expert weights)."""
    r = np.random.default_rng(seed)

    def rand(*shape, scale=0.05):
        return (r.standard_normal(shape) * scale).astype(np.float32)

    sd = {"word_embeddings.weight": rand(V, d),
          "position_embeddings.weight": rand(32, d),
          "transformer.final_layernorm.weight": 1 + rand(d),
          "transformer.final_layernorm.bias": rand(d)}
    for i in range(L):
        m = f"transformer.layers.{i}."
        sd[m + "input_layernorm.weight"] = 1 + rand(d)
        sd[m + "input_layernorm.bias"] = rand(d)
        sd[m + "attention.query_key_value.weight"] = rand(3 * d, d)
        sd[m + "attention.query_key_value.bias"] = rand(3 * d)
        sd[m + "attention.dense.weight"] = rand(d, d)
        sd[m + "attention.dense.bias"] = rand(d)
        sd[m + "post_attention_layernorm.weight"] = 1 + rand(d)
        sd[m + "post_attention_layernorm.bias"] = rand(d)
        g = m + "mlp.deepspeed_moe."
        sd[g + "gate.wg.weight"] = rand(E, d, scale=0.5)          # Linear [E, d]
        for e in range(E):
            ex = g + f"experts.deepspeed_experts.{e}."
            sd[ex + "dense_h_to_4h.weight"] = rand(f, d)
            sd[ex + "dense_h_to_4h.bias"] = rand(f)
            sd[ex + "dense_4h_to_h.weight"] = rand(d, f)
            sd[ex + "dense_4h_to_h.bias"] = rand(d)
    cfg = {"model_type": "megatron_gpt_moe", "vocab_size": V, "hidden_size": d,
           "num_layers": L, "num_attention_heads": 4, "max_position_embeddings": 32,
           "intermediate_size": f, "num_experts": E, "moe_top_k": 1}
    return cfg, sd


def _item10_masters(engine) -> dict:
    """The fp32 masters by path: the host's under offload, else gathered."""
    off = engine._offload or engine._param_offload
    if off is None:
        return _full(engine)
    return {k: np.array(v) for k, v in off.read_masters().items()}


def _item10_view(engine) -> dict:
    """The compute params the forward reads (gathered, quantized under
    qwZ), by path, at fp32."""
    out = {}

    def walk(tree, prefix=""):
        for k in (list(tree.keys()) if isinstance(tree, dict) else range(len(tree))):
            v, path = tree[k], f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, (dict, list, tuple)):
                walk(v, path)
            else:
                out[path] = v.detach().float().numpy()

    with torch.no_grad():
        walk(engine._view(engine._work_tree()))
    return out


def prog_item10(cases: list, batches):
    """Each case: a ``tiny`` engine (``dtype``, default bf16; JAX's tree
    from ``params_np`` or the seed's) trained on ``batches[:steps]``;
    losses, norms, the comms logger's bytes by op and dtype, the count of
    quantized leaves, the masters, the 1-bit error buffers, and with
    ``view`` the compute params the first step reads; a case with
    ``ckpt`` saves after ``save_at`` steps, trains on, and a fresh engine
    resumes and trains the same steps (both trajectories returned)."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models import CausalLM
    from deepspeed_tpu_torch.models.convert import params_from_jax

    def build(case):
        model = CausalLM(case.get("model", "tiny"),
                         dtype=getattr(torch, case.get("dtype", "bfloat16")))
        params = (params_from_jax(case["params_np"], device="cpu")
                  if case.get("params_np") is not None else None)
        if params is not None and case.get("dtype") == "float64":
            from deepspeed_tpu_torch.utils.tree import tree_map

            params = tree_map(lambda x: x.double(), params)
        engine, *_ = ds.initialize(model=model, config=case["config"], device="cpu",
                                   params=params)
        return engine

    def train(engine, bs):
        losses, norms = [], []
        for b in bs:
            losses.append(float(engine.train_batch(batch=b)))
            norms.append(float(engine.get_global_grad_norm()))
        return losses, norms

    out = []
    for case in cases:
        engine = build(case)
        rec = {"view": _item10_view(engine)} if case.get("view") else {}
        logger = comm.get_comms_logger()
        if logger is not None:
            logger.reset()
        bs = batches[:case.get("steps", len(batches))]
        if case.get("ckpt"):
            k = case["save_at"]
            train(engine, bs[:k])
            engine.save_checkpoint(case["ckpt"], tag="t")
            rec["after"] = train(engine, bs[k:])[0]
            rec["after_masters"] = _item10_masters(engine)
            engine = build(case)
            engine.load_checkpoint(case["ckpt"], tag="t")
            rec["resumed"] = train(engine, bs[k:])[0]
            rec["resumed_masters"] = _item10_masters(engine)
        else:
            rec["losses"], rec["norms"] = train(engine, bs)
            rec["masters"] = _item10_masters(engine)
        rec["dtypes"] = logger.totals_by_dtype() if logger is not None else None
        rec["num_quantized"] = (engine.partition.num_quantized_leaves
                                if engine.partition is not None else 0)
        err = engine._comm_error
        rec["errors"] = ([e.numpy() for e in err] if isinstance(err, list) else
                         [e.numpy() for e in err.error] if err is not None else None)
        if err is not None and hasattr(err, "acc"):   # 0/1 Adam: the synced masters
            local = _flat(engine.state.master_params if engine.state.master_params
                          is not None else engine.state.params)
            rec["synced"] = {k: (v.float() - a).numpy()
                             for (k, v), a in zip(local.items(), err.acc)}
        out.append(rec)
        del engine
    return out


def prog_quant_coll(layout: dict, xs, dys, gs, bits: int):
    """The ZeRO++ collectives on this rank's piece of each input: codes and
    scales of its shard, the quantized all-gather (and its backward, plain
    and qgZ), the one-hop reduce-scatter over 'data' and, on a layout
    with 'data_outer', the two-hop one."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.ops import quantizer as qz
    from deepspeed_tpu_torch.parallel.mesh import MeshLayout, initialize_mesh

    initialize_mesh(MeshLayout(**layout))
    comm.configure({"enabled": True})
    r = comm.get_rank()
    x = torch.from_numpy(xs[r])
    q, scale = qz.quantize_blockwise(x, block=64, bits=bits)
    out = {"q": q.numpy(), "scale": scale.numpy()}
    axis = "data" if layout.get("dp_outer", 1) == 1 else ("data_outer", "data")
    for gb in (None, 8):
        xg = x.clone().requires_grad_()
        y = qz.quantized_all_gather(xg, axis, gather_dim=0, block=64, bits=bits,
                                    out_dtype=torch.float32, grad_bits=gb)
        y.backward(torch.from_numpy(dys[r]))
        out[f"gather{gb}"] = y.detach().numpy()
        out[f"dx{gb}"] = xg.grad.numpy()
    g = torch.from_numpy(gs[r])
    out["rs"] = qz.quantized_reduce_scatter(g, "data", scatter_dim=0, block=64,
                                            bits=bits).numpy()
    if layout.get("dp_outer", 1) > 1:
        out["hier"] = qz.hierarchical_quantized_reduce_scatter(
            g, "data", "data_outer", scatter_dim=0, block=64, bits=bits).numpy()
    out["dtypes"] = comm.get_comms_logger().totals_by_dtype()
    return out


def prog_onebit_coll(flats, errors, steps: int):
    """``compressed_mean`` over 'data', ``steps`` times, each rank's error
    carried: the means and the errors of every step."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.parallel.mesh import MeshLayout, initialize_mesh
    from deepspeed_tpu_torch.runtime.comm.compressed import compressed_mean

    initialize_mesh(MeshLayout(dp=comm.get_world_size()))
    comm.configure({"enabled": True})
    r = comm.get_rank()
    err = torch.from_numpy(errors[r])
    out = []
    for t in range(steps):
        m, err = compressed_mean(torch.from_numpy(flats[t][r]), err, "data", block=64)
        out.append((m.numpy(), err.numpy()))
    return {"steps": out, "dtypes": comm.get_comms_logger().totals_by_dtype()}


def prog_infinity(config: dict, batches, ckpt_dir: str, save_at: int):
    """ZeRO-Infinity (``tiny``, bf16, the seed's weights) trained on
    ``batches``, saved after ``save_at`` steps, then a fresh engine resumed
    from the save: each run's losses, norms and this rank's master shards
    (``masters1`` after the first step),
    the leaves' shard dims, the shapes its files hold, its host gradient
    bytes and the bytes under its NVMe directory."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import CausalLM

    def build():
        engine, *_ = ds.initialize(model=CausalLM("tiny"), config=config, device="cpu")
        return engine

    def train(engine, bs):
        losses, norms = [], []
        for b in bs:
            losses.append(float(engine.train_batch(batch=b)))
            norms.append(float(engine.get_global_grad_norm()))
        return losses, norms

    engine = build()
    off = engine._param_offload
    losses, norms = train(engine, batches[:1])
    first = {k: np.array(v) for k, v in off.read_masters().items()}
    more = train(engine, batches[1:save_at])
    losses, norms = losses + more[0], norms + more[1]
    engine.save_checkpoint(ckpt_dir, tag="t")
    after, after_norms = train(engine, batches[save_at:])
    root = off.swapper.swap_dir
    out = {"losses": losses + after, "norms": norms + after_norms, "masters1": first,
           "masters": {k: np.array(v) for k, v in off.read_masters().items()},
           "shard_dims": dict(off.shard_dims),
           "file_shapes": {n: tuple(off.swapper.shape(f"{n}.master"))
                           for n in off._leaf_names},
           "host_grad_bytes": off.stats["host_grad_bytes"],
           "nvme_bytes": sum(os.path.getsize(os.path.join(d, f))
                             for d, _, fs in os.walk(root) for f in fs)}
    engine = build()
    engine.load_checkpoint(ckpt_dir, tag="t")
    out["resumed"] = train(engine, batches[save_at:])[0]
    out["resumed_masters"] = {k: np.array(v)
                              for k, v in engine._param_offload.read_masters().items()}
    return out


def prog_sparse(rows, values, dense_rows: int):
    """``sparse_allreduce`` over 'data' of this rank's (rows, values)."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.parallel.mesh import MeshLayout, initialize_mesh
    from deepspeed_tpu_torch.runtime.sparse_tensor import SparseTensor, sparse_allreduce

    initialize_mesh(MeshLayout(dp=comm.get_world_size()))
    r = comm.get_rank()
    out = sparse_allreduce(SparseTensor(torch.from_numpy(rows[r]), torch.from_numpy(values[r]),
                                        dense_rows), "data")
    return {"rows": out.rows.numpy(), "values": out.values.numpy(),
            "dense": out.to_dense().numpy()}


def prog_lora(config: dict, base_np, lora_np, batches, prompts, max_new: int):
    """A ``LoRAModel`` over ``tiny`` (fp32) trained on ``batches`` under
    ``config``; the losses, the whole adapter tree (gathered) and the
    hybrid engine's greedy tokens after training."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import CausalLM
    from deepspeed_tpu_torch.models.convert import lora_from_jax, params_from_jax
    from deepspeed_tpu_torch.runtime.hybrid_engine import DeepSpeedHybridEngine
    from deepspeed_tpu_torch.runtime.lora import LoRAConfig, LoRAModel

    model = LoRAModel(CausalLM("tiny", dtype=torch.float32),
                      params_from_jax(base_np, device="cpu"), LoRAConfig(rank=4, alpha=8.0))
    engine, *_ = ds.initialize(model=model, config=config, device="cpu",
                               params=lora_from_jax(lora_np, device="cpu"))
    losses = [float(engine.train_batch(batch=b)) for b in batches]
    tokens = DeepSpeedHybridEngine(engine).generate(prompts, max_new_tokens=max_new)
    return {"losses": losses, "lora": _full(engine), "tokens": tokens.numpy(),
            "local_shapes": _shapes(engine.state.master_params
                                    if engine.state.master_params is not None
                                    else engine.state.params)}


def prog_compress_view(cases: list, params_np):
    """Each case: the compressed compute tree a step differentiates, each
    leaf gathered whole (collective), by path, in fp32."""
    from deepspeed_tpu_torch.utils.tree import tree_leaves

    out = []
    for case in cases:
        engine = _engine(case, params_np)
        part, leaves = engine.partition, tree_leaves(engine._work_tree())
        specs = part.placements("param")
        paths = list(_flat(engine.state.params))
        out.append({p: part.whole_true(i, specs[i], x.detach()).float().numpy()
                    for i, (p, x) in enumerate(zip(paths, leaves))})
        del engine
    return out


def prog_replicas(tree_np, bad_rank: int, bad_leaf: str):
    """``utils.debug.assert_replicas_consistent`` over the world on a tree
    every rank builds alike, but for one leaf on ``bad_rank`` (none when
    ``bad_rank`` < 0): ("ok", checksums) or ("raised", message)."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.utils.debug import assert_replicas_consistent

    tree = {k: torch.from_numpy(v.copy()) for k, v in tree_np.items()}
    if comm.get_rank() == bad_rank:
        tree[bad_leaf].view(-1)[0] += 1
    try:
        return "ok", assert_replicas_consistent(tree, name="probe")
    except RuntimeError as e:
        return "raised", str(e)


PROGRAMS = {"item10": prog_item10, "infinity": prog_infinity, "sparse": prog_sparse,
            "lora": prog_lora, "quant_coll": prog_quant_coll,
            "onebit_coll": prog_onebit_coll, "comm": prog_comm, "moe_infer": prog_moe_infer, "train": prog_train, "checkpoint": prog_checkpoint,
            "tiling": prog_tiling, "serve": prog_serve, "ring": prog_ring,
            "routing": prog_routing, "generate": prog_generate, "generic": prog_generic,
            "subset": prog_subset, "multi": prog_multi, "sp_gate": prog_sp_gate,
            "hf_load": prog_hf_load, "quant_tp": prog_quant_tp,
            "serve_extras": prog_serve_extras, "compress_view": prog_compress_view,
            "replicas": prog_replicas}


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
