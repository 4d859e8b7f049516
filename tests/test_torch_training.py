"""The port's training path against the JAX package's.

The same numpy weights (a JAX ``init_params`` tree crossed with
``params_from_jax``) and the same numpy batches go into both engines.  The
JAX engine runs on the 8 virtual devices of tests/conftest.py with one
sample per device; the port runs one device with the same global
micro-batch of 8.  Both run in fp32 on the CPU, so they differ only in
summation order: the 4-step loss trajectory agrees at rtol 1e-5, the final
parameters at rtol 1e-5 with atol 1e-5 (0.3% of one step at lr 3e-3).
Adam divides each gradient by its own running magnitude, so an element
whose gradient sits at the level of summation noise moves by a
noise-dependent share of the step: at most 0.1% of a leaf's elements may
miss that tolerance, and every element stays within atol 1e-4 (3% of one
step).  The other tests hold the port's own contracts, as
tests/unit/test_engine.py holds the JAX engine's.
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
from deepspeed_tpu.runtime import lr_schedules as jax_lr
from deepspeed_tpu.runtime import optimizer as jax_opt
from deepspeed_tpu.runtime.fp16 import loss_scaler as jax_ls
from deepspeed_tpu_torch.models import CausalLM
from deepspeed_tpu_torch.models.convert import params_from_jax, params_to_numpy
from deepspeed_tpu_torch.runtime import lr_schedules as port_lr
from deepspeed_tpu_torch.runtime import optimizer as port_opt
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.fp16 import loss_scaler as port_ls
from deepspeed_tpu_torch.utils.tree import tree_flatten_with_path, tree_leaves

TRAJ_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL_EVERY = dict(rtol=1e-5, atol=1e-4)
PARAM_OFF_SHARE = 1e-3
S = 32


def _config(**extra):
    cfg = {
        "train_micro_batch_size_per_gpu": 8,
        "gradient_accumulation_steps": 2,
        "optimizer": {"type": "adamw",
                      "params": {"lr": 3e-3, "weight_decay": 0.1,
                                 "betas": [0.9, 0.95], "eps": 1e-8}},
        "scheduler": {"type": "WarmupLR",
                      "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 3e-3,
                                 "warmup_num_steps": 3, "warmup_type": "linear"}},
        "gradient_clipping": 0.5,
        "steps_per_print": 10 ** 9,
    }
    cfg.update(extra)
    return cfg


def _jax_params(name, seed=0):
    jcfg = jtf.get_config(name, dtype=jnp.float32)
    return jax.tree_util.tree_map(
        np.asarray, jtf.init_params(jcfg, jax.random.PRNGKey(seed)))


def _batches(vocab, n, B=16, seed=1):
    rs = np.random.RandomState(seed)
    return [{"input_ids": rs.randint(0, vocab, (B, S)).astype(np.int32)}
            for _ in range(n)]


def _port_engine(name, np_params, config, **model_kw):
    model = CausalLM(name, dtype=torch.float32, **model_kw)
    engine, *_ = ds.initialize(model=model, config=config, device="cpu",
                               params=params_from_jax(np_params, device="cpu"))
    return engine


@pytest.mark.parametrize("name", ["tiny", "tiny-gqa", "tiny-gpt2"])
def test_engine_matches_jax_engine(name):
    """AdamW + weight decay + clipping + WarmupLR + gas=2, fp32: the
    4-step loss trajectory and the final parameters."""
    np_params = _jax_params(name)
    jcfg = _config(train_micro_batch_size_per_gpu=1)   # x 8 virtual devices
    jeng, *_ = deepspeed_tpu.initialize(
        model=JaxCausalLM(name, dtype=jnp.float32), config=jcfg,
        params=jax.tree_util.tree_map(jnp.asarray, np_params))
    teng = _port_engine(name, np_params, _config())
    assert jeng.train_batch_size == teng.train_batch_size == 16
    batches = _batches(256, 2) * 2
    jl = [float(jeng.train_batch(batch=b)) for b in batches]
    tl = [float(teng.train_batch(batch=b)) for b in batches]
    np.testing.assert_allclose(tl, jl, rtol=TRAJ_RTOL)
    assert tl[2] < tl[0] and tl[3] < tl[1]   # each batch's loss fell
    np.testing.assert_allclose(teng.get_global_grad_norm(),
                               jeng.get_global_grad_norm(), rtol=1e-4)
    np.testing.assert_allclose(teng.get_current_lr(), jeng.get_current_lr(),
                               rtol=1e-6)
    jp = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                          jeng.get_params()))
    tp = tree_leaves(params_to_numpy(teng.get_params()))
    assert len(jp) == len(tp)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a, b, **PARAM_TOL_EVERY)
        assert (~np.isclose(a, b, **PARAM_TOL)).mean() <= PARAM_OFF_SHARE


@pytest.mark.parametrize("remat", [False, True])
def test_flash_autograd_grads_match_plain_branch(remat):
    """``attn_impl="pallas"`` (the autograd Function over the plain dq/dk/dv
    versions on the CPU) gives the plain attention branch's gradients, with
    and without remat."""
    np_params = _jax_params("tiny-gqa", seed=4)
    tokens = torch.from_numpy(_batches(256, 1, B=2, seed=5)[0]["input_ids"])
    grads = {}
    for impl in ("pallas", "xla"):
        model = CausalLM("tiny-gqa", dtype=torch.float32, attn_impl=impl,
                         remat=remat)
        params = params_from_jax(np_params, device="cpu")
        leaves = [p.requires_grad_() for p in tree_leaves(params)]
        loss = model.loss_fn(params, {"input_ids": tokens})
        grads[impl] = torch.autograd.grad(loss, leaves)
    for a, b in zip(grads["pallas"], grads["xla"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


def test_loss_and_grads_match_jax_model():
    """``CausalLM.loss_fn`` and its gradient against ``jax.grad`` of the JAX
    model's ``loss_fn`` on the same tree and batch (labels default to the
    shifted tokens)."""
    np_params = _jax_params("tiny", seed=6)
    batch = _batches(256, 1, B=2, seed=7)[0]
    jm = JaxCausalLM("tiny", dtype=jnp.float32, attn_impl="xla")
    jloss, jgrads = jax.value_and_grad(jm.loss_fn)(
        jax.tree_util.tree_map(jnp.asarray, np_params),
        {"input_ids": jnp.asarray(batch["input_ids"])}, jax.random.PRNGKey(0))
    model = CausalLM("tiny", dtype=torch.float32, attn_impl="xla")
    params = params_from_jax(np_params, device="cpu")
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    loss = model.loss_fn(params, {"input_ids": torch.from_numpy(batch["input_ids"])})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for a, b in zip(grads, jax.tree_util.tree_leaves(jgrads)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)
    assert model.param_count == jm.param_count == sum(p.numel() for p in leaves)


def test_dropout_remat_recomputes_the_same_masks():
    """With dropout on, a layer recomputed under remat redraws the masks of
    its first run: the gradients with and without remat are equal, and a
    different generator seed gives a different loss."""
    np_params = _jax_params("tiny", seed=8)
    tokens = torch.from_numpy(_batches(256, 1, B=2, seed=9)[0]["input_ids"])
    out = {}
    for remat in (False, True):
        model = CausalLM("tiny", dtype=torch.float32, dropout=0.2, remat=remat)
        params = params_from_jax(np_params, device="cpu")
        leaves = [p.requires_grad_() for p in tree_leaves(params)]
        loss = model.loss_fn(params, {"input_ids": tokens},
                             torch.Generator().manual_seed(3))
        out[remat] = (loss, torch.autograd.grad(loss, leaves))
        other = model.loss_fn(params, {"input_ids": tokens},
                              torch.Generator().manual_seed(4))
        assert abs(other.item() - loss.item()) > 1e-4
        assert model.eval_fn(params, {"input_ids": tokens}).item() != loss.item()
    torch.testing.assert_close(out[True][0], out[False][0], rtol=0, atol=0)
    for a, b in zip(out[True][1], out[False][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_gradient_accumulation_matches_large_batch():
    """gas=4 over micro-batches of 4 == one batch of 16 (the loss is a mean
    over tokens and every sample has S-1 labels).  Adam is blind to the
    gradient's scale, so the global gradient norm is compared too (rtol
    1e-5).  Adam's first step moves an element by lr * g / (|g| + eps),
    so where g is of the order of eps the summation order shows: the
    parameters agree to 1% of the step (atol 1e-5 at lr 1e-3)."""
    np_params = _jax_params("tiny", seed=10)
    batch = _batches(256, 1, seed=11)[0]
    base = dict(optimizer={"type": "adam", "params": {"lr": 1e-3}})
    e1 = _port_engine("tiny", np_params, {"train_batch_size": 16, **base})
    e4 = _port_engine("tiny", np_params, {"train_batch_size": 16,
                                          "gradient_accumulation_steps": 4, **base})
    assert (e1.gas, e4.gas, e4.micro_batch_size) == (1, 4, 4)
    np.testing.assert_allclose(float(e4.train_batch(batch=batch)),
                               float(e1.train_batch(batch=batch)), rtol=1e-5)
    np.testing.assert_allclose(e4.get_global_grad_norm(), e1.get_global_grad_norm(),
                               rtol=1e-5)
    for a, b in zip(tree_leaves(e4.get_params()), tree_leaves(e1.get_params())):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def _quadratic_engine(config):
    """A functional model (``loss_fn`` + ``params``): mean((x @ w)^2)."""
    w = torch.from_numpy(np.random.RandomState(0).standard_normal((8, 4))
                         .astype(np.float32))

    def loss_fn(params, batch, rng):
        y = batch["x"].to(params["w"].dtype) @ params["w"]
        return y.float().square().mean()

    engine, *_ = ds.initialize(loss_fn=loss_fn, params={"w": w}, config=config,
                               device="cpu")
    return engine


def test_fp16_overflow_skips_step_and_backs_off_the_scale():
    engine = _quadratic_engine({"train_batch_size": 4, "fp16": {"enabled": True},
                                "optimizer": {"type": "adam", "params": {"lr": 0.1}}})
    assert engine.loss_scale == 2.0 ** 16
    assert engine.state.params["w"].dtype == torch.float16
    before = engine.state.master_params["w"].clone()
    bad = {"x": np.ones((4, 8), np.float32)}
    bad["x"][0, 0] = np.inf
    # hysteresis=2: the first overflow only uses it up, the second halves
    # the scale; both skip the step
    engine.train_batch(batch=bad)
    assert engine.loss_scale == 2.0 ** 16
    engine.train_batch(batch=bad)
    assert engine.loss_scale == 2.0 ** 15
    assert engine.skipped_steps == 2 and engine.global_steps == 2
    torch.testing.assert_close(engine.state.master_params["w"], before,
                               rtol=0, atol=0)
    # small enough that the scaled fp16 gradient stays finite at 2**15
    good = {"x": np.full((4, 8), 0.01, np.float32)}
    engine.train_batch(batch=good)
    assert not torch.equal(engine.state.master_params["w"], before)
    assert engine.skipped_steps == 2


def test_bf16_masters_stay_fp32():
    engine = _port_engine("tiny", _jax_params("tiny", seed=12),
                          _config(bf16={"enabled": True},
                                  data_types={"grad_accum_dtype": "bf16"}))
    for b in _batches(256, 2, seed=13):
        engine.train_batch(batch=b)
    assert all(p.dtype == torch.bfloat16 for p in tree_leaves(engine.get_params()))
    masters = tree_leaves(engine.get_params(fp32=True))
    assert all(m.dtype == torch.float32 for m in masters)
    for p, m in zip(tree_leaves(engine.get_params()), masters):
        torch.testing.assert_close(p, m.to(torch.bfloat16), rtol=0, atol=0)
    assert np.isfinite(engine.get_global_grad_norm())


_SCHEDULES = {
    "LRRangeTest": dict(lr_range_test_min_lr=1e-4, lr_range_test_step_size=7,
                        lr_range_test_step_rate=0.5, lr_range_test_staircase=True),
    "OneCycle": dict(cycle_min_lr=1e-4, cycle_max_lr=1e-2, cycle_first_step_size=10,
                     cycle_second_step_size=15, decay_step_size=5,
                     decay_lr_rate=0.3),
    "WarmupLR": dict(warmup_min_lr=1e-5, warmup_max_lr=1e-3, warmup_num_steps=20),
    "WarmupDecayLR": dict(total_num_steps=40, warmup_min_lr=0.0,
                          warmup_max_lr=2e-3, warmup_num_steps=10,
                          warmup_type="linear"),
    "CosineAnnealing": dict(total_num_steps=45, warmup_num_steps=5,
                            warmup_max_lr=1e-3, cosine_min_ratio=0.1),
}


@pytest.mark.parametrize("kind", sorted(_SCHEDULES))
def test_lr_schedule_matches_jax(kind):
    """rtol 1e-5: the JAX schedules evaluate in fp32 (a few ulp of rounding
    through their arithmetic), the port's in Python floats."""
    jsched = jax_lr.get_lr_scheduler(kind, _SCHEDULES[kind])
    tsched = port_lr.get_lr_scheduler(kind, _SCHEDULES[kind])
    got = [tsched(step) for step in range(50)]
    want = [float(jsched(step)) for step in range(50)]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12)
    assert port_lr.constant_lr(0.25)(7) == float(jax_lr.constant_lr(0.25)(7))


@pytest.mark.parametrize("mu_dtype,nu_dtype", [("bfloat16", None),
                                               ("bfloat16", "bfloat16"),
                                               (None, "bfloat16"),
                                               ("bfloat16", "float32")])
def test_adam_moment_dtypes_match_jax(mu_dtype, nu_dtype):
    """``mu_dtype``/``nu_dtype`` through the whole chain (clip -> Adam ->
    decayed weights -> -lr), 5 updates: updates and stored moments."""
    rs = np.random.RandomState(20)
    params = {"a": rs.standard_normal((16, 8)).astype(np.float32),
              "b": rs.standard_normal((8,)).astype(np.float32)}
    hyper = {"lr": 1e-2, "weight_decay": 0.05, "mu_dtype": mu_dtype,
             "nu_dtype": nu_dtype}
    sched = jax_lr.get_lr_scheduler("WarmupLR", {"warmup_num_steps": 3,
                                                 "warmup_max_lr": 1e-2})
    jtx = jax_opt.create_optimizer("adamw", hyper, sched, gradient_clipping=1.0)
    ttx = port_opt.create_optimizer(
        "adamw", hyper, port_lr.get_lr_scheduler(
            "WarmupLR", {"warmup_num_steps": 3, "warmup_max_lr": 1e-2}),
        gradient_clipping=1.0)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jtx.init(jp), ttx.init(tp)
    for step in range(5):
        g = {k: rs.standard_normal(v.shape).astype(np.float32) * (0.1 + step)
             for k, v in params.items()}
        ju, js = jtx.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tu, ts = ttx.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
        for k in params:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]),
                                       rtol=1e-5, atol=1e-8)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, ju)
        tp = port_opt.apply_updates(tp, tu)
    adam = ts[1][0]
    jadam = js[1][0]
    for mine, theirs in ((adam.mu, jadam.mu), (adam.nu, jadam.nu)):
        for k in params:
            assert str(mine[k].dtype).replace("torch.", "") == str(theirs[k].dtype)
            np.testing.assert_allclose(mine[k].float().numpy(),
                                       np.asarray(theirs[k], np.float32),
                                       rtol=1e-2 if "16" in str(theirs[k].dtype)
                                       else 1e-5, atol=1e-8)
    assert adam.count == int(jadam.count) == 5


def test_loss_scaler_matches_jax():
    flags = [True, False, False, True, True, True, False, True, False, False,
             False, True]
    j = jax_ls.dynamic_loss_scale_state(initial_scale_power=4, loss_scale_window=3,
                                        min_loss_scale=2.0, hysteresis=2)
    t = port_ls.dynamic_loss_scale_state(initial_scale_power=4, loss_scale_window=3,
                                         min_loss_scale=2.0, hysteresis=2)
    for f in flags:
        j = jax_ls.update_scale(j, jnp.bool_(f))
        t = port_ls.update_scale(t, f)
        assert t.loss_scale == float(j.loss_scale)
        assert (t.good_steps, t.hysteresis) == (int(j.good_steps), int(j.hysteresis))
    static = port_ls.static_loss_scale_state(128.0)
    assert port_ls.update_scale(static, False) == static
    assert port_ls.grads_finite({"a": torch.ones(2), "b": torch.zeros(1)})
    assert not port_ls.grads_finite({"a": torch.tensor([1.0, float("nan")])})
    assert float(port_ls.scale_loss(torch.tensor(2.0), static)) == 256.0


def test_dataloader_and_batch_forms():
    """training_data at initialize (a RepeatingLoader over epochs), an
    iterator of gas micro-batches, and a [gas, mb, ...] stacked batch all
    feed the same step."""
    np_params = _jax_params("tiny", seed=14)
    data = [{"input_ids": x} for x in
            np.random.RandomState(15).randint(0, 256, (6, S)).astype(np.int32)]
    cfg = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
           "optimizer": {"type": "adam", "params": {"lr": 1e-3}}}
    model = CausalLM("tiny", dtype=torch.float32)
    engine, _, loader, sched = ds.initialize(
        model=model, config=cfg, training_data=data, device="cpu",
        params=params_from_jax(np_params, device="cpu"))
    assert len(loader) == 3 and sched(0) == 1e-3
    losses = [float(engine.train_batch()) for _ in range(3)]   # crosses an epoch
    assert np.isfinite(losses).all() and engine.global_steps == 3
    micro = [{"input_ids": np.stack([d["input_ids"] for d in data[i:i + 2]])}
             for i in (0, 2)]
    fresh = [_port_engine("tiny", np_params, cfg) for _ in range(3)]
    a = float(fresh[0].train_batch(data_iter=iter(micro)))
    b = float(fresh[1].train_batch(
        batch={"input_ids": np.stack([m["input_ids"] for m in micro])}))
    c = float(fresh[2].train_batch(
        batch={"input_ids": np.concatenate([m["input_ids"] for m in micro])}))
    assert a == b == c
    with pytest.raises(ValueError, match="neither train_batch_size"):
        fresh[0].train_batch(batch={"input_ids": micro[0]["input_ids"][:1]})


# item 11's tooling half is ported: its blocks now build their feature on
# the engine (the attribute each wires); the rest still raise
PORTED_OPTIONS = {"compression_training": "_compression_transform",
                  "tensorboard": "monitor", "flops_profiler": "flops_profiler"}


@pytest.mark.parametrize("option", [
    {"compression_training": {}},
    {"tensorboard": {"enabled": True}},
    {"flops_profiler": {"enabled": True}},
    {"resilience": {"watchdog": {"enabled": True}}},
], ids=lambda o: "-".join(str(k) for k in o))
def test_unported_options_raise(option, tmp_path):
    cfg = {"train_batch_size": 2, **option}
    key = next(iter(option))
    if key in PORTED_OPTIONS:
        if key == "tensorboard":
            cfg["tensorboard"] = {"enabled": True, "output_path": str(tmp_path)}
        eng, *_ = ds.initialize(model=CausalLM("tiny", dtype=torch.float32), config=cfg,
                                device="cpu")
        # an empty compression block wires nothing, as in the JAX engine
        assert (getattr(eng, PORTED_OPTIONS[key]) is None) == (key == "compression_training")
        return
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
        ds.initialize(model=CausalLM("tiny", dtype=torch.float32), config=cfg,
                      device="cpu")


@pytest.mark.parametrize("option", [
    {"sparse_gradients": True},
    {"checkpoint": {"load_universal": True}},
    {"checkpoint": {"use_node_local_storage": True}},
    {"activation_checkpointing": {"cpu_checkpointing": True}},
], ids=lambda o: "-".join(str(k) for k in o))
def test_inert_knobs_raise(option):
    """Knobs that parse but do nothing (in the JAX package too) are refused."""
    cfg = {"train_batch_size": 2, **option}
    with pytest.raises(NotImplementedError, match="does not implement"):
        ds.initialize(model=CausalLM("tiny", dtype=torch.float32), config=cfg,
                      device="cpu")


class _TensorParallelMPU:
    @staticmethod
    def get_model_parallel_world_size():
        return 2


def test_unported_entry_points_raise():
    """What the trainer still refuses: a model-parallel degree above 1
    without a process group (tensor parallelism runs one rank per device,
    ``tests/test_torch_tp.py``), and JAX's refusals of random-LTD and
    progressive layer drop with per-layer attention windows (both run
    otherwise: ``tests/test_torch_pld_ltd.py``)."""
    with pytest.raises(RuntimeError, match="process group"):
        ds.initialize(model=CausalLM("tiny"), config={"train_batch_size": 2},
                      mpu=_TensorParallelMPU(), device="cpu")
    batch = {"input_ids": torch.zeros((1, 8), dtype=torch.long)}
    windows = {"attention_layers": ("global", "local")}
    with pytest.raises(NotImplementedError, match="random-LTD with per-layer attention"):
        model = CausalLM("tiny", random_ltd=True, random_ltd_keep=4, **windows)
        model.loss_fn(model.init_fn(device="cpu"), batch)
    with pytest.raises(NotImplementedError, match="progressive layer drop with per-layer"):
        model = CausalLM("tiny", **windows)
        model.loss_fn(model.init_fn(device="cpu"), {**batch, "pld_theta": 0.5})
    for kw, extra in (({"random_ltd": True, "random_ltd_keep": 4}, {}),
                      ({}, {"pld_theta": 0.5})):
        model = CausalLM("tiny", **kw)
        assert torch.isfinite(model.loss_fn(model.init_fn(device="cpu"),
                                            {**batch, **extra}))
    for policy in ("save_attn", "save_qkv", "save_matmuls", "dots_saveable"):
        model = CausalLM("tiny", dtype=torch.float32, remat=True,
                         remat_policy=policy)
        params = model.init_fn(device="cpu")
        assert torch.isfinite(model.loss_fn(params, batch))
        with torch.no_grad():   # inference does not remat
            assert torch.isfinite(model.eval_fn(params, batch))


def test_config_batch_triad_and_precision():
    c = DeepSpeedConfig({"train_batch_size": 32, "gradient_accumulation_steps": 4},
                        dp_world_size=1)
    assert (c.train_batch_size, c.train_micro_batch_size_per_gpu,
            c.gradient_accumulation_steps) == (32, 8, 4)
    assert DeepSpeedConfig({"train_batch_size": 2, "bf16": {"enabled": True}}) \
        .precision == torch.bfloat16
    with pytest.raises(Exception, match="inconsistent"):
        DeepSpeedConfig({"train_batch_size": 10, "train_micro_batch_size_per_gpu": 3,
                         "gradient_accumulation_steps": 2}, dp_world_size=1)
    with pytest.raises(Exception, match="both"):
        DeepSpeedConfig({"fp16": {"enabled": True}, "bf16": {"enabled": True}})


# ---------------------------------------------------------------------------
# forward/backward/step, frozen parameters, timers
# ---------------------------------------------------------------------------

def _jax_engine(name, np_params, config, **model_kw):
    jeng, *_ = deepspeed_tpu.initialize(
        model=JaxCausalLM(name, dtype=jnp.float32, **model_kw), config=config,
        params=jax.tree_util.tree_map(jnp.asarray, np_params))
    return jeng


def test_forward_backward_step_equals_train_batch():
    """Two steps of gas 2 through forward/backward/step and through
    train_batch, dropout on (the loop draws the same seeds in the same
    order): losses and every parameter bit for bit."""
    np_params = _jax_params("tiny", seed=30)
    batches = _batches(256, 2, seed=31)
    cfg = _config()
    a = _port_engine("tiny", np_params, cfg, dropout=0.1)
    b = _port_engine("tiny", np_params, cfg, dropout=0.1)
    for batch in batches:
        la = a.train_batch(batch=batch)
        micro = batch["input_ids"].reshape(2, 8, S)
        for i in range(2):
            b.backward(b.forward({"input_ids": micro[i]}))
        metrics = b.step()
        assert torch.equal(metrics["loss"], la)
    assert a.global_steps == b.global_steps == 2
    assert a.micro_steps == b.micro_steps == 4
    assert a.get_global_grad_norm() == b.get_global_grad_norm()
    for x, y in zip(tree_leaves(a.state.master_params or a.state.params),
                    tree_leaves(b.state.master_params or b.state.params)):
        assert torch.equal(x, y)


def test_forward_backward_step_contracts_match_jax():
    """The boundary flag after each call, the mid-window no-op and the four
    misuse errors, side by side with the JAX engine (which asserts where the
    port raises RuntimeError for two of them)."""
    np_params = _jax_params("tiny", seed=32)
    batch = _batches(256, 1, B=8, seed=33)[0]
    teng = _port_engine("tiny", np_params, _config())
    jeng = _jax_engine("tiny", np_params, _config(train_micro_batch_size_per_gpu=1))
    errors = (AssertionError, RuntimeError)

    def trace(eng):
        flags = []
        with pytest.raises(errors, match="no accumulated gradients"):
            eng.step()
        with pytest.raises(errors, match="without a preceding forward"):
            eng.backward()
        eng.forward(batch)
        with pytest.raises(errors, match="missing its backward"):
            eng.step()
        eng.backward()
        flags.append(eng.is_gradient_accumulation_boundary())
        mid = eng.step()
        flags.append(mid is None)
        eng.backward(eng.forward(batch))
        flags.append(eng.is_gradient_accumulation_boundary())
        with pytest.raises(errors, match="beyond the accumulation window"):
            eng.forward(batch)
        flags.append(eng.step() is not None)
        flags.append(eng.is_gradient_accumulation_boundary())
        return flags, eng.global_steps

    got, want = trace(teng), trace(jeng)
    assert got == want == ([False, True, True, True, False], 1)
    with pytest.raises(RuntimeError):
        teng.backward()


@pytest.mark.parametrize("name,keywords", [
    ("tiny-gpt2", ("embed",)),
    ("tiny-gpt2", "embed"),
    ("tiny", ("layers/wq", "lm_head")),
    ("tiny-gqa", ("wk", "final_norm_scale")),
])
def test_frozen_spec_equals_jax(name, keywords):
    """Exact-segment matching: 'embed' freezes ``embed`` and not
    ``pos_embed``; a string keyword is one keyword, not its characters."""
    from deepspeed_tpu.utils.debug import path_str

    jmask = jax.tree_util.tree_flatten_with_path(
        JaxCausalLM(name, frozen_keywords=keywords).frozen_spec())[0]
    tmask = tree_flatten_with_path(CausalLM(name, frozen_keywords=keywords)
                                   .frozen_spec())
    assert tmask == [(path_str(p), m) for p, m in jmask]
    assert any(m for _, m in tmask) and not all(m for _, m in tmask)
    for cls in (CausalLM, JaxCausalLM):
        with pytest.raises(ValueError, match="matched no parameter"):
            cls(name, frozen_keywords=("emb",)).frozen_spec()
        assert cls(name).frozen_spec() is None


def test_frozen_trajectory_matches_jax_engine():
    """frozen_keywords=("embed", "wq"), AdamW with weight decay, clipping,
    gas 2: the 4-step trajectory and the final parameters agree with the
    JAX engine's (the tolerances of test_engine_matches_jax_engine); the
    frozen leaves do not move a bit and their Adam moments stay zero."""
    name, keywords = "tiny", ("embed", "wq")
    np_params = _jax_params(name, seed=34)
    jeng = _jax_engine(name, np_params, _config(train_micro_batch_size_per_gpu=1),
                       frozen_keywords=keywords)
    teng = _port_engine(name, np_params, _config(), frozen_keywords=keywords)
    batches = _batches(256, 2, seed=35) * 2
    jl = [float(jeng.train_batch(batch=b)) for b in batches]
    tl = [float(teng.train_batch(batch=b)) for b in batches]
    np.testing.assert_allclose(tl, jl, rtol=TRAJ_RTOL)
    np.testing.assert_allclose(teng.get_global_grad_norm(),
                               jeng.get_global_grad_norm(), rtol=1e-4)
    start = params_from_jax(np_params, device="cpu")
    assert torch.equal(teng.state.params["embed"], start["embed"])
    assert torch.equal(teng.state.params["layers"]["wq"], start["layers"]["wq"])
    assert not torch.equal(teng.state.params["layers"]["wk"], start["layers"]["wk"])
    adam = teng.state.opt_state[1][0]
    for moments in (adam.mu, adam.nu):
        assert not moments["embed"].any() and not moments["layers"]["wq"].any()
        assert moments["layers"]["wk"].any()
    jp = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                          jeng.get_params()))
    for a, b in zip(tree_leaves(params_to_numpy(teng.get_params())), jp):
        np.testing.assert_allclose(a, b, **PARAM_TOL_EVERY)
        assert (~np.isclose(a, b, **PARAM_TOL)).mean() <= PARAM_OFF_SHARE


def test_grad_norm_excludes_frozen():
    """The reported norm is the trainable leaves' norm (the frozen ones have
    no gradient, as with requires_grad=False)."""
    name = "tiny"
    np_params = _jax_params(name, seed=36)
    batch = _batches(256, 1, seed=37)[0]
    cfg = {"train_batch_size": 16, "optimizer": {"type": "adam",
                                                 "params": {"lr": 1e-3}}}
    engine = _port_engine(name, np_params, cfg, frozen_keywords=("embed",))
    engine.train_batch(batch=batch)
    model = CausalLM(name, dtype=torch.float32)
    params = params_from_jax(np_params, device="cpu")
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    grads = torch.autograd.grad(
        model.loss_fn(params, {"input_ids": torch.from_numpy(batch["input_ids"])}),
        leaves)
    mask = tree_leaves(CausalLM(name, frozen_keywords=("embed",)).frozen_spec())
    live = torch.sqrt(sum(g.square().sum() for g, m in zip(grads, mask) if not m))
    full = torch.sqrt(sum(g.square().sum() for g in grads))
    np.testing.assert_allclose(engine.get_global_grad_norm(), live.item(), rtol=1e-5)
    assert abs(live.item() - full.item()) > 1e-3 * full.item()


def test_client_optimizer_is_masked_too():
    """A client chain (weight decay included) gets the frozen masking."""
    np_params = _jax_params("tiny", seed=38)
    tx = port_opt.chain(port_opt.scale_by_adam(), port_opt.add_decayed_weights(0.5),
                        port_opt.scale_by_learning_rate(1e-2))
    model = CausalLM("tiny", dtype=torch.float32, frozen_keywords=("lm_head",))
    engine, *_ = ds.initialize(model=model, optimizer=tx, device="cpu",
                               config={"train_batch_size": 16},
                               params=params_from_jax(np_params, device="cpu"))
    before = engine.state.params["lm_head"].clone()
    engine.train_batch(batch=_batches(256, 1, seed=39)[0])
    assert torch.equal(engine.state.params["lm_head"], before)
    assert not torch.equal(engine.state.params["embed"],
                           params_from_jax(np_params, device="cpu")["embed"])


def test_breakdown_knobs_and_timers():
    """wall_clock_breakdown and memory_breakdown are accepted and the
    engine holds named timers (as the JAX engine does, which times nothing
    with them itself)."""
    from deepspeed_tpu_torch.utils.memory import memory_status, see_memory_usage

    cfg = {"train_batch_size": 2, "wall_clock_breakdown": True,
           "memory_breakdown": True}
    engine = _port_engine("tiny", _jax_params("tiny", seed=40), cfg)
    assert engine.config.wall_clock_breakdown and engine.config.memory_breakdown
    timer = engine.timers("fwd")
    for _ in range(2):
        timer.start()
        sum(range(1000))
        timer.stop()
    assert engine.timers.has("fwd") and not engine.timers.has("bwd")
    mean = engine.timers.get_mean(["fwd"])["fwd"]
    line = engine.timers.log(["fwd"], memory_breakdown=True)
    assert mean > 0 and line.startswith("time (ms) | fwd: ")
    assert engine.timers("fwd").elapsed() == 0.0   # log reset it
    with pytest.raises(RuntimeError, match="not started"):
        timer.stop()
    assert see_memory_usage("x") is None
    report = memory_status("x", reset_max=True)
    assert report["device"] is None and report["host_peak_rss_gb"] > 0


@pytest.mark.parametrize("kw", [{}, {"gradient_clipping": 0.05}, {"bf16": {"enabled": True}},
                                 {"fp16": {"enabled": True, "loss_scale": 0}}])
def test_leafwise_update_is_the_tree_update_bit_for_bit(kw):
    """The one-device engine updates a leaf at a time (its memory: one
    leaf's temporaries); the tree-wide chain on the same gradients gives
    the same masters, moments, compute params and norms, bit for bit, with
    clipping, bf16 over fp32 masters and fp16's loss scale."""
    np_params = _jax_params("tiny-moe")
    batches = _batches(256, 3, B=16)
    config = _config(**kw)
    out = []
    for leafwise in (True, False):
        engine = _port_engine("tiny-moe", np_params, config)
        assert engine._leafwise
        engine._leafwise = leafwise
        losses = [float(engine.train_batch(batch=b)) for b in batches]
        out.append((losses, engine.get_global_grad_norm(), engine.state))
    from deepspeed_tpu_torch.runtime.checkpoint_engine.dcp_engine import flatten_state

    (la, na, sa), (lb, nb, sb) = out
    assert la == lb and na == nb
    flat_a, flat_b = {}, {}
    flatten_state(sa, "state", flat_a)
    flatten_state(sb, "state", flat_b)
    assert sorted(flat_a) == sorted(flat_b) and any("/mu/" in k for k in flat_a)
    for k in flat_a:
        assert torch.equal(flat_a[k], flat_b[k]), k
