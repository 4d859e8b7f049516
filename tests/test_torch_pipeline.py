"""The port's pipeline parallelism (``runtime/pipe``, the transformer
family's pipelined training) against the JAX package, on the CPU.

- **Schedules**: the cases of ``tests/unit/test_pipe_schedule.py`` on the
  port's copy, whose ``TrainSchedule``/``InferenceSchedule`` instruction
  streams equal JAX's instruction for instruction; ``GPipeSchedule``'s
  fill/drain clock and its pairing of every send with a receive.
- **PipelineModule**: partitioning, ties, the ragged-stage and tied-stage
  refusals with JAX's messages, the stacked ``[P, ...]`` tree of JAX's
  ``init_fn``, and pipelined training equal to the sequential loss.
- **Gradients**: ``pipeline_1f1b_loss_and_grads`` (every stage virtual in
  one process) against JAX's ``pipeline_1f1b_loss_and_grads`` and
  against JAX's dense fp64 gradients, for GPipe and 1F1B, with the tied
  embedding's two gradients summed (``tiny-gpt2``) and MoE aux (GPipe).
  JAX computes the loss in fp32 in both, so gradients agree at rtol 1e-6
  of each leaf's largest entry.
- **Training over gloo ranks**: pp=2 (GPipe and 1F1B) and pp=2 x dp=2
  (ZeRO-2) against the single-device fp64 JAX engine at 5e-6.  The
  pipelined step takes the whole gas window in one call, so its loss is
  the window's mean over every labelled token, as the JAX pipeline
  engine's: the reference is the dense engine at gas=1 on the same
  window.  Virtual stages in one process equal it too.
- **Checkpoints**: a save at pp=2 loads at pp=1 bit for bit, and back.
- **Refusals**: JAX's 1F1B refusals (MoE, dropout, prescale), its mesh and
  microbatch checks, and ``forward``/``backward``/``step`` on a pipeline
  engine.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch as ds
from deepspeed_tpu.models import CausalLM as JaxCausalLM
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.parallel import mesh as jmesh
from deepspeed_tpu.runtime.pipe import schedule as jsched
from deepspeed_tpu_torch.models import CausalLM
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.models.convert import params_from_jax, params_to_numpy
from deepspeed_tpu_torch.runtime.pipe import (BackwardPass, ForwardPass, GPipeSchedule,
                                              InferenceSchedule, LayerSpec, LoadMicroBatch,
                                              OptimizerStep, PipelineModule, RecvActivation,
                                              RecvGrad, SendActivation, SendGrad,
                                              TiedLayerSpec, TrainSchedule,
                                              partition_balanced)
from deepspeed_tpu_torch.utils.tree import tree_flatten_with_path, tree_leaves, tree_map

from ._torch_ranks import make_batches, run_ranks

torch.set_num_threads(1)

TOL = dict(rtol=5e-6, atol=5e-6)
STEPS, TRAIN_BATCH, GAS, CLIP = 3, 8, 2, 0.05
DEADLINE = 90.0
LAYERS = 4


# ---------------------------------------------------------------------------
# Schedules (tests/unit/test_pipe_schedule.py's cases)
# ---------------------------------------------------------------------------

def _flat(sched):
    return [cmd for step in sched for cmd in step]


@pytest.mark.parametrize("micro,stages", [(4, 2), (8, 4), (2, 2), (4, 4)])
def test_train_schedule_runs_every_microbatch_once(micro, stages):
    for stage in range(stages):
        for cls in (TrainSchedule, GPipeSchedule):
            cmds = _flat(cls(micro, stages, stage))
            assert sum(isinstance(c, ForwardPass) for c in cmds) == micro
            assert sum(isinstance(c, BackwardPass) for c in cmds) == micro
            assert sum(isinstance(c, OptimizerStep) for c in cmds) == 1


@pytest.mark.parametrize("micro,stages", [(4, 2), (8, 4), (3, 3), (6, 3)])
def test_schedules_equal_jax_instruction_streams(micro, stages):
    """The copied TrainSchedule and InferenceSchedule give JAX's streams."""
    for stage in range(stages):
        for ours, theirs in ((TrainSchedule, jsched.TrainSchedule),
                             (InferenceSchedule, jsched.InferenceSchedule)):
            got = [[repr(c) for c in step] for step in ours(micro, stages, stage)]
            want = [[repr(c) for c in step] for step in theirs(micro, stages, stage)]
            assert got == want


def test_train_schedule_forward_precedes_backward_per_buffer():
    seen = set()
    for step in TrainSchedule(micro_batches=4, stages=2, stage_id=0):
        for cmd in step:
            if isinstance(cmd, ForwardPass):
                seen.add(cmd.buffer_id)
            if isinstance(cmd, BackwardPass):
                assert cmd.buffer_id in seen


def test_edge_stages_load_microbatches():
    for cls in (TrainSchedule, GPipeSchedule):
        assert sum(isinstance(c, LoadMicroBatch) for c in _flat(cls(4, 3, 0))) == 4
        assert sum(isinstance(c, LoadMicroBatch) for c in _flat(cls(4, 3, 1))) == 0
        assert sum(isinstance(c, LoadMicroBatch) for c in _flat(cls(4, 3, 2))) == 4


def test_train_schedule_is_1f1b_in_steady_state():
    phases = "".join("F" if isinstance(c, ForwardPass) else "B"
                     for c in _flat(TrainSchedule(6, 3, 2))
                     if isinstance(c, (ForwardPass, BackwardPass)))
    assert phases == "FB" * 6


def test_gpipe_schedule_fills_then_drains():
    """Every forward before any backward on each stage; each tick's sends
    pair with the neighbour's receives of that tick (the executor's
    contract), so the stream never waits on a message not yet sent."""
    M, P = 5, 3
    streams = [list(GPipeSchedule(M, P, s)) for s in range(P)]
    for s in range(P):
        kinds = "".join("F" if isinstance(c, ForwardPass) else "B"
                        for c in _flat(streams[s])
                        if isinstance(c, (ForwardPass, BackwardPass)))
        assert kinds == "F" * M + "B" * M
    for t in range(len(streams[0])):
        for s in range(P - 1):
            sends = sum(isinstance(c, SendActivation) for c in streams[s][t])
            recvs = sum(isinstance(c, RecvActivation) for c in streams[s + 1][t])
            assert sends == recvs
            sends = sum(isinstance(c, SendGrad) for c in streams[s + 1][t])
            recvs = sum(isinstance(c, RecvGrad) for c in streams[s][t])
            assert sends == recvs


def test_inference_schedule_wavefront():
    for stage in range(3):
        cmds = _flat(InferenceSchedule(micro_batches=5, stages=3, stage_id=stage))
        assert sum(isinstance(c, ForwardPass) for c in cmds) == 5
        assert not any(isinstance(c, BackwardPass) for c in cmds)


# ---------------------------------------------------------------------------
# PipelineModule
# ---------------------------------------------------------------------------

def test_partition_balanced_and_tied():
    assert partition_balanced([1, 1, 1, 1], 2) == [0, 2, 4]
    assert partition_balanced([4, 1, 1, 1, 1], 2) == [0, 1, 5]

    class Lin:
        def __init__(self, n):
            self.param_count = n

    layers = [TiedLayerSpec("embed", Lin, 10), LayerSpec(Lin, 1),
              LayerSpec(Lin, 1), TiedLayerSpec("embed", Lin, 10)]
    pm = PipelineModule(layers, num_stages=2, partition_method="parameters")
    assert pm.parts[0] == 0 and pm.parts[-1] == 4
    assert pm.tied_keys() == {"embed": [0, 3]}
    assert pm.stage_of_layer(0) == 0 and pm.stage_of_layer(3) == 1


class _Tanh:
    """A functional layer: ``init(generator)`` / ``apply(params, x)``."""

    def __init__(self, d=8):
        self.d = d
        self.param_count = d * d

    def init(self, gen):
        return {"w": torch.randn(self.d, self.d, generator=gen, dtype=torch.float64) * 0.3}

    def apply(self, p, x):
        return torch.tanh(x @ p["w"])


def _mse(out, batch):
    return ((out - batch["y"]) ** 2).mean()


def test_pipeline_module_refusals_carry_jax_messages():
    ragged = PipelineModule([LayerSpec(_Tanh, 8), LayerSpec(_Tanh, 8),
                             LayerSpec(_Tanh, 16)], num_stages=2,
                            partition_method="uniform", loss_fn=_mse)
    with pytest.raises(ValueError, match="structurally identical stages"):
        ragged.init_fn(torch.Generator(), device="cpu")
    tied = PipelineModule([TiedLayerSpec("t", _Tanh, 8), LayerSpec(_Tanh, 8),
                           LayerSpec(_Tanh, 8), TiedLayerSpec("t", _Tanh, 8)],
                          num_stages=2, partition_method="uniform", loss_fn=_mse)
    with pytest.raises(ValueError, match="TiedLayerSpec is not supported"):
        tied.init_fn(torch.Generator(), device="cpu")
    with pytest.raises(ValueError, match="unknown partition_method"):
        PipelineModule([LayerSpec(_Tanh)], 1, partition_method="bogus")


def test_pipeline_module_trains_as_its_sequential_loss():
    """4 layers on 2 stages, 4 microbatches: the engine's pipelined steps
    equal a one-stage engine's steps on the same weights (its tree the
    JAX layout: ``stages`` of ``[P, ...]`` leaves with 'pipe' specs)."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(8, 8, generator=gen, dtype=torch.float64)
    batch = {"inputs": x, "y": torch.tanh(x @ torch.randn(8, 8, generator=gen,
                                                          dtype=torch.float64))}
    pm = PipelineModule([LayerSpec(_Tanh) for _ in range(4)], num_stages=2,
                        loss_fn=_mse, microbatches=4)
    params = pm.init_fn(torch.Generator().manual_seed(1), device="cpu")
    assert len(params["stages"]) == 2 and params["stages"][0]["w"].shape == (2, 8, 8)
    assert pm.param_specs == {"stages": [{"w": ("pipe", None, None)}] * 2}
    cfg = {"train_batch_size": 8, "optimizer": {"type": "adamw", "params": {"lr": 1e-2}},
           "steps_per_print": 10 ** 9}
    eng, *_ = ds.initialize(model=pm, config=cfg, device="cpu",
                            params=tree_map(lambda t: t.clone(), params))
    seq = PipelineModule([LayerSpec(_Tanh) for _ in range(4)], num_stages=1, loss_fn=_mse)
    seq_params = {"layers": [{"w": params["stages"][j]["w"][s]}
                             for s in range(2) for j in range(2)], "tied": {}}
    ref, *_ = ds.initialize(model=seq, config=cfg, device="cpu", params=seq_params)
    for _ in range(3):   # the microbatches' gradients summed in fp32 (the
        # accumulation dtype), the one-stage engine's cast once: rtol 1e-6
        a, b = float(eng.train_batch(batch=batch)), float(ref.train_batch(batch=batch))
        np.testing.assert_allclose(a, b, rtol=1e-6)
    np.testing.assert_allclose(eng.get_global_grad_norm(), ref.get_global_grad_norm(),
                               rtol=1e-6)   # the norm is taken in fp32
    assert float(pm.loss_fn(params, batch)) > 0


# ---------------------------------------------------------------------------
# Gradients against JAX
# ---------------------------------------------------------------------------

def _jax_tree(name, seed=0, **kw):
    return jax.tree_util.tree_map(np.asarray, jtf.init_params(
        jtf.get_config(name, num_layers=LAYERS, **kw), jax.random.PRNGKey(seed)))


def _close_to(got, want, rtol=1e-6):
    """Each leaf within ``rtol`` of its largest entry (the key bias's true
    gradient is 0, so an elementwise rtol means nothing there)."""
    for (path, g), w in zip(tree_flatten_with_path(got), jax.tree_util.tree_leaves(want)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=rtol * max(np.abs(w).max(), 1e-3), err_msg=path)


@pytest.mark.parametrize("name,schedule", [("tiny", "gpipe"), ("tiny", "1f1b"),
                                           ("tiny-gpt2", "gpipe"), ("tiny-gpt2", "1f1b"),
                                           ("tiny-moe", "gpipe")])
def test_pipeline_grads_match_jax_dense(name, schedule):
    """2 virtual stages, 2 microbatches, fp64: the loss and every gradient
    against JAX's dense fp64 ``value_and_grad`` of the un-pipelined loss
    (the tied embedding: stage 0's and the head's gradients summed; MoE:
    the aux's gradient from every stage)."""
    jax.config.update("jax_enable_x64", True)
    try:
        np_tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), _jax_tree(name))
        toks = np.random.RandomState(1).randint(0, 256, (4, 32)).astype(np.int32)
        jm = JaxCausalLM(name, dtype=jnp.float64, num_layers=LAYERS)
        jl, jg = jax.value_and_grad(lambda p: jm.loss_fn(
            p, {"input_ids": jnp.asarray(toks)}, jax.random.PRNGKey(0)))(
            jax.tree_util.tree_map(jnp.asarray, np_tree))
    finally:
        jax.config.update("jax_enable_x64", False)
    cfg = ttf.get_config(name, dtype=torch.float64, num_layers=LAYERS, pipeline_stages=2,
                         pipeline_microbatches=2, pipeline_schedule=schedule)
    labels = np.concatenate([toks[:, 1:], np.full((4, 1), -100)], 1)
    if schedule == "1f1b":
        grads, per_micro = ttf.pipeline_1f1b_loss_and_grads(
            cfg, params_from_jax(np_tree, "cpu"), torch.from_numpy(toks),
            torch.from_numpy(labels))
        loss = per_micro.mean()
    else:   # MoE: the aux term rides each stage's backward
        work = tree_map(lambda x: x.requires_grad_(), params_from_jax(np_tree, "cpu"))
        losses, aux = ttf.pipeline_loss_and_backward(
            cfg, work, torch.from_numpy(toks), torch.from_numpy(labels))
        loss = sum(losses.values()) + (0 if aux is None else aux)
        grads = tree_map(lambda x: x.grad, work)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    _close_to(grads, jg)


def test_1f1b_grads_match_jax_pipeline_1f1b():
    """Against JAX's own ``pipeline_1f1b_loss_and_grads`` (its SPMD 1F1B
    scan) on the JAX pipelined tree ``[P, L/P, ...]`` (converted both
    ways), loss-scaled: the per-microbatch losses and the gradients."""
    jcfg = jtf.get_config("tiny", dtype=jnp.float32, num_layers=LAYERS, pipeline_stages=2,
                          pipeline_microbatches=4, pipeline_schedule="1f1b")
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(2))
    toks = np.random.RandomState(3).randint(0, 256, (8, 16)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((8, 1), -100)], 1).astype(np.int32)
    jg, jl = jtf.pipeline_1f1b_loss_and_grads(jcfg, jparams, jnp.asarray(toks),
                                              jnp.asarray(labels), jax.random.PRNGKey(0),
                                              loss_scale=8.0)
    np_tree = jax.tree_util.tree_map(np.asarray, jparams)
    tcfg = ttf.get_config("tiny", dtype=torch.float32, num_layers=LAYERS, pipeline_stages=2,
                          pipeline_microbatches=4, pipeline_schedule="1f1b")
    tg, tl = ttf.pipeline_1f1b_loss_and_grads(
        tcfg, params_from_jax(np_tree, "cpu", pipeline_stages=2), torch.from_numpy(toks),
        torch.from_numpy(labels), loss_scale=8.0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-6)
    back = params_to_numpy(tg, pipeline_stages=2)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jg)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-5 * max(np.abs(b).max(), 1e-3))


def test_pipelined_forward_equals_unpipelined():
    """A pipelined config's ``forward`` (inference, eval loss) is the same
    function as the un-pipelined one, on the port's ``[L, ...]`` tree."""
    np_tree = _jax_tree("tiny")
    toks = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (2, 16)))
    a = ttf.forward(ttf.get_config("tiny", dtype=torch.float32, num_layers=LAYERS),
                    params_from_jax(np_tree, "cpu"), toks)
    b = ttf.forward(ttf.get_config("tiny", dtype=torch.float32, num_layers=LAYERS,
                                   pipeline_stages=2), params_from_jax(np_tree, "cpu"), toks)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    spec = ttf.param_specs(ttf.get_config("tiny", num_layers=LAYERS, pipeline_stages=2))
    assert spec["layers"]["wq"] == ("pipe", None, "model")
    assert spec["embed"] == ("model", None)


# ---------------------------------------------------------------------------
# Training over gloo ranks, and virtual stages in one process
# ---------------------------------------------------------------------------

def _config(stage=0, gas=GAS, **extra):
    cfg = {"train_batch_size": TRAIN_BATCH, "gradient_accumulation_steps": gas,
           "gradient_clipping": CLIP,
           "optimizer": {"type": "adamw",
                         "params": {"lr": 1e-3, "weight_decay": 0.1,
                                    "mu_dtype": "float64", "nu_dtype": "float64"}},
           "zero_optimization": {"stage": stage}, "steps_per_print": 10 ** 9}
    cfg.update(extra)
    return cfg


def _flat_np(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def batches():
    return make_batches(STEPS, TRAIN_BATCH)


@pytest.fixture(scope="module")
def jax_runs(batches):
    """The single-device fp64 JAX engine at gas=1 on each whole window
    (the pipeline engines' loss: the window's mean over its tokens)."""
    out = {}
    jax.config.update("jax_enable_x64", True)
    try:
        for name in ("tiny", "tiny-gpt2", "tiny-moe"):
            params_np = _jax_tree(name)
            jmesh.reset_mesh()
            mesh = jmesh.initialize_mesh(jmesh.MeshLayout(dp=1), devices=jax.devices()[:1])
            model = JaxCausalLM(jtf.get_config(name, dtype=jnp.float64, num_layers=LAYERS))
            eng, *_ = deepspeed_tpu.initialize(
                model=model, config=_config(gas=1),
                params=jax.tree_util.tree_map(jnp.asarray, params_np), mesh=mesh)
            losses = [float(eng.train_batch(batch={k: v.astype(np.int32)
                                                   for k, v in b.items()}))
                      for b in batches]
            out[name] = (params_np, {"losses": losses, "params": _flat_np(eng.get_params())})
    finally:
        jax.config.update("jax_enable_x64", False)
        jmesh.reset_mesh()
    return out


PP_CASES = [
    ("pp2_gpipe", 2, {"pp": 2}, 0, "tiny", "gpipe"),
    ("pp2_1f1b", 2, {"pp": 2}, 0, "tiny", "1f1b"),
    ("pp2_1f1b_tied", 2, {"pp": 2}, 1, "tiny-gpt2", "1f1b"),
    ("pp2_gpipe_moe", 2, {"pp": 2}, 0, "tiny-moe", "gpipe"),
    ("pp2_dp2_1f1b_stage2", 4, {"pp": 2, "dp": 2}, 2, "tiny", "1f1b"),
    ("dp2_virtual_gpipe", 2, {"dp": 2}, 1, "tiny-gpt2", "gpipe"),
]


@pytest.fixture(scope="module")
def pp_spawn(tmp_path_factory, jax_runs, batches):
    tmp = tmp_path_factory.mktemp("pp")
    out = {}
    for world in (2, 4):
        cases = [c for c in PP_CASES if c[1] == world]
        res = run_ranks(world, "train", tmp, timeout=DEADLINE, cases=[
            {"config": _config(stage), "model": name, "mesh": mesh,
             "params_np": jax_runs[name][0],
             "model_kw": {"num_layers": LAYERS, "pipeline_stages": 2,
                          "pipeline_microbatches": 4, "pipeline_schedule": sched}}
            for _, _, mesh, stage, name, sched in cases], params_np=None, batches=batches)
        for i, case in enumerate(cases):
            out[case[0]] = [r[i] for r in res]
    return out


@pytest.mark.parametrize("case", [c[0] for c in PP_CASES])
def test_pipeline_training_matches_jax(case, pp_spawn, jax_runs):
    """Every rank reports the global loss; the gathered weights (each pipe
    rank holds its stage's 2 layers) equal the fp64 JAX engine's at 5e-6."""
    _, world, mesh, stage, name, _ = next(c for c in PP_CASES if c[0] == case)
    ref = jax_runs[name][1]
    for r in pp_spawn[case]:
        np.testing.assert_allclose(r["losses"], ref["losses"], **TOL)
        for k, v in r["masters"].items():
            np.testing.assert_allclose(v, ref["params"][k], err_msg=k, **TOL)
        layers = r["master_shapes"]["layers/wq"][0]
        assert layers == LAYERS // mesh.get("pp", 1)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_virtual_stages_in_one_process_match_jax(schedule, jax_runs, batches):
    """All stages in this process (the card's ``pipeline`` phase): the same
    trajectory, the gas window in one call."""
    params_np, ref = jax_runs["tiny"]
    model = CausalLM("tiny", dtype=torch.float64, num_layers=LAYERS, pipeline_stages=2,
                     pipeline_microbatches=4, pipeline_schedule=schedule)
    engine, *_ = ds.initialize(model=model, config=_config(), device="cpu",
                               params=tree_map(lambda x: x.double(),
                                               params_from_jax(params_np, "cpu")))
    assert engine.pipelined
    losses = [float(engine.train_batch(batch=b)) for b in batches]
    np.testing.assert_allclose(losses, ref["losses"], **TOL)
    for p, x in tree_flatten_with_path(engine.get_params(fp32=True)):
        np.testing.assert_allclose(x.numpy(), ref["params"][p], err_msg=p, **TOL)


def test_pipeline_checkpoints_cross_layouts(tmp_path, jax_runs):
    """ZeRO-1 at pp=2 saves; dp=2 loads the whole masters bit for bit; a
    save at dp=2 resumes at pp=2 with the losses of the run that never
    stopped (gas=1: both take the window's mean; the pipelined NLL sums
    over microbatches in another order, so fp32 rounding, rtol 1e-6)."""
    params_np = jax_runs["tiny"][0]
    kw = dict(config=_config(1, gas=1), params_np=params_np,
              batches=make_batches(4, TRAIN_BATCH, 3),
              model="tiny", dtype="float64",
              model_kw={"num_layers": LAYERS, "pipeline_stages": 2})
    saved = run_ranks(2, "checkpoint", tmp_path, timeout=DEADLINE,
                      ckpt_dir=str(tmp_path / "pp2"), mode="save", mesh={"pp": 2}, **kw)
    loaded = run_ranks(2, "checkpoint", tmp_path, timeout=DEADLINE,
                       ckpt_dir=str(tmp_path / "pp2"), mode="load", mesh={"dp": 2}, **kw)
    assert saved[0]["saved"]["layers/wq"].shape == (LAYERS, 64, 64)
    for k in saved[0]["saved"]:
        np.testing.assert_array_equal(loaded[0]["saved"][k], saved[0]["saved"][k])
    back = run_ranks(2, "checkpoint", tmp_path, timeout=DEADLINE,
                     ckpt_dir=str(tmp_path / "dp2"), mode="save", mesh={"dp": 2}, **kw)
    resumed = run_ranks(2, "checkpoint", tmp_path, timeout=DEADLINE,
                        ckpt_dir=str(tmp_path / "dp2"), mode="resume", mesh={"pp": 2}, **kw)
    for k in back[0]["saved"]:
        np.testing.assert_array_equal(resumed[0]["saved"][k], back[0]["saved"][k])
    np.testing.assert_allclose(resumed[0]["losses"], back[0]["losses"][2:], rtol=1e-6)


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------

def test_refusals_carry_jax_messages():
    p = params_from_jax(_jax_tree("tiny"), "cpu")
    toks = torch.zeros((4, 8), dtype=torch.long)
    for kw, match in (({"num_experts": 4}, "1f1b' with MoE"),
                      ({"dropout": 0.1}, "1f1b' with dropout")):
        cfg = ttf.get_config("tiny", num_layers=LAYERS, pipeline_stages=2,
                             pipeline_schedule="1f1b", **kw)
        with pytest.raises(NotImplementedError, match=match):
            ttf.pipeline_1f1b_loss_and_grads(cfg, p, toks, toks)
    with pytest.raises(ValueError, match="not divisible by pipeline stages"):
        ttf.param_specs(ttf.get_config("tiny", num_layers=3, pipeline_stages=2))
    model = CausalLM("tiny", dtype=torch.float32, num_layers=LAYERS, pipeline_stages=2,
                     pipeline_microbatches=3)
    with pytest.raises(ValueError, match="microbatches"):
        ds.initialize(model=model, config=_config(), device="cpu", params=p)
    model = CausalLM("tiny", dtype=torch.float32, num_layers=LAYERS, pipeline_stages=2,
                     pipeline_schedule="1f1b")
    with pytest.raises(NotImplementedError, match="prescale_gradients"):
        ds.initialize(model=model, config=_config(prescale_gradients=True), device="cpu",
                      params=p)
    engine, *_ = ds.initialize(model=CausalLM("tiny", dtype=torch.float32,
                                              num_layers=LAYERS, pipeline_stages=2),
                               config=_config(), device="cpu", params=p)
    batch = {"input_ids": toks}
    for call in (lambda: engine.forward(batch), engine.backward, engine.step):
        with pytest.raises(RuntimeError, match="pipeline engines train with train_batch"):
            call()
    assert len(tree_leaves(engine.state.params)) == len(tree_leaves(p))
