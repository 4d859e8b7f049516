"""The port's compression training (``deepspeed_tpu_torch/compression``,
the engine's transform and the model's activation fake-quant) against the
JAX package's.

Inputs come from numpy seeds; weights cross through ``models/convert.py``.
Tolerances:

- the primitives (fake-quant values, STE gradients, masks, the bit
  schedule) and ``build_param_transform`` on the ``tiny`` tree: exact (the
  same fp32 arithmetic, round half to even, the same k-th largest);
- the fp64 QAT + pruning trajectory (loss of the transformed tree, its
  gradient applied to the untransformed tree by SGD, as the JAX engine
  differentiates its transformed compute tree): parameters at atol 1e-7
  and the loss within 2 fp32 ulps (atol 1e-6): both packages take the
  norms and the cross-entropy in fp32 whatever the model's dtype;
- the engines (bf16 compute over fp64 masters, fp64 activations): the
  first two losses at rtol 1e-5 against the JAX engine (later steps part
  by the bf16 rounding of the gradients, as without compression);
- ZeRO-3 over 2 gloo ranks and tp=2: the compressed compute tree,
  gathered, exactly the whole-leaf transform; four SGD steps against the
  one-device port engine: tp=2 at rtol 1e-6 (masters atol 1e-5), ZeRO-3's
  first loss at rtol 1e-6 and the rest at rtol 2e-3 (see the test);
- activation fake-quant: the norms and rope run in fp32 in both packages
  whatever the model's dtype, so an fp64 model's norm outputs agree to an
  fp32 ulp, and an element that sits at a rounding boundary of the 8-bit
  grid may land one level apart, which moves the logits by ~2e-4.  The
  sites are held exactly with a smooth stand-in for the fake-quant
  (``x * 1.125 - 0.01``, the same calls in the same order, logits at atol
  1e-6); the real fake-quant (dense forward, a cached decode, a paged tick
  over three slots of one batch) at atol 1e-3, below the 3.5e-3 that
  per-row instead of per-tensor statistics would move them;
- ``redundancy_clean`` / ``student_initialization``: exact.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
from deepspeed_tpu import compression as J
from deepspeed_tpu.models import CausalLM as JaxCausalLM
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.parallel import mesh as mesh_mod

import deepspeed_tpu_torch as ds
from deepspeed_tpu_torch import compression as T
from deepspeed_tpu_torch.models import CausalLM
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.models.convert import params_from_jax, pool_from_jax
from deepspeed_tpu_torch.utils.tree import tree_flatten_with_path, tree_leaves, tree_map

from ._torch_ranks import _run_case, make_batches, run_ranks

torch.set_num_threads(1)

COMP = {
    "weight_quantization": {
        "shared_parameters": {"enabled": True, "quantization_type": "symmetric",
                              "schedule_offset": 1},
        "different_groups": {"wq": {"params": {"start_bits": 8, "target_bits": 4,
                                               "quantization_period": 2},
                                    "modules": ["layers/w"]}}},
    "sparse_pruning": {
        "shared_parameters": {"enabled": True, "schedule_offset": 2, "method": "l1"},
        "different_groups": {"sp": {"params": {"dense_ratio": 0.5},
                                    "modules": ["w_gate", "w_up", "w_down"]}}},
    "head_pruning": {
        "shared_parameters": {"enabled": True, "schedule_offset": 0},
        "different_groups": {"hp": {"params": {"dense_ratio": 0.5}, "modules": ["wo"]}}},
}
ACT_QUANT = {"activation_quantization": {
    "shared_parameters": {"enabled": True, "quantization_type": "asymmetric"},
    "different_groups": {"aq": {"params": {"bits": 8}, "modules": ["*"]}}}}


@contextlib.contextmanager
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def _flat_np(tree) -> dict:
    return {p: _np(x) for p, x in tree_flatten_with_path(tree)}


def _jax_flat(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
            for path, x in flat}


@pytest.fixture(scope="module")
def params_np():
    return jax.tree_util.tree_map(
        np.asarray, jtf.init_params(jtf.get_config("tiny"), jax.random.PRNGKey(0)))


# ------------------------------------------------------------------ quantize --

@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("symmetric", [True, False], ids=["sym", "asym"])
@pytest.mark.parametrize("per_channel", [False, True], ids=["tensor", "channel"])
def test_quantize_ste_values_match_jax(bits, symmetric, per_channel):
    w = np.random.default_rng(bits).normal(size=(3, 16, 24)).astype(np.float32)
    ref = np.asarray(J.quantize_ste(jnp.asarray(w), bits, symmetric, per_channel))
    got = T.quantize_ste(torch.from_numpy(w), bits, symmetric, per_channel).numpy()
    np.testing.assert_array_equal(got, ref)
    levels = np.unique(got[0, :, 0] if per_channel else got)
    assert len(levels) <= 2 ** bits
    assert T.quantize_ste(torch.from_numpy(w), 16) is not None
    assert torch.equal(T.quantize_ste(torch.from_numpy(w), 16), torch.from_numpy(w))


def test_asymmetric_range_matches_jax():
    w = np.random.default_rng(0).uniform(0.5, 1.5, (64,)).astype(np.float32)
    ref = np.asarray(J.quantize_ste(jnp.asarray(w), 4, symmetric=False))
    got = T.quantize_ste(torch.from_numpy(w), 4, symmetric=False).numpy()
    np.testing.assert_array_equal(got, ref)
    # the affine grid spans [min, max] (not [-max, max]): within half a step
    assert np.abs(got - w).max() <= (w.max() - w.min()) / 15 / 2 + 1e-6


def test_ste_gradient_inside_on_and_outside_the_range():
    """The saturating straight-through gradient: passed inside the closed
    range (its ends included), 0 outside — JAX's ``_ste_round_clip``."""
    x = np.array([-9.0, -8.0, -3.3, 0.0, 2.5, 7.0, 7.4, 12.0], np.float32)
    weights = np.arange(1.0, 9.0, dtype=np.float32)
    jg = jax.grad(lambda v: jnp.sum(J.activation_fake_quant(v, 4, static_range=7.0)
                                    * weights))(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    (T.activation_fake_quant(t, 4, static_range=7.0) * torch.from_numpy(weights)).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(jg))
    # -8 and 7 are the range's ends (passed); -9, 7.4 and 12 lie outside
    np.testing.assert_array_equal(t.grad.numpy() != 0,
                                  [False, True, True, True, True, True, False, False])
    # dynamic range: every element inside, the gradient straight through
    w = np.random.default_rng(3).normal(size=(5, 7)).astype(np.float32)
    for sym in (True, False):
        jg = jax.grad(lambda v: jnp.sum(J.quantize_ste(v, 4, sym) * 2.0))(jnp.asarray(w))
        t = torch.from_numpy(w).requires_grad_()
        (T.quantize_ste(t, 4, sym) * 2.0).sum().backward()
        np.testing.assert_array_equal(t.grad.numpy(), np.asarray(jg))


def test_activation_fake_quant_matches_jax():
    x = np.random.default_rng(1).normal(size=(8, 16)).astype(np.float32)
    for kw in ({}, {"symmetric": True}, {"static_range": 4.0}):
        ref = np.asarray(J.activation_fake_quant(jnp.asarray(x), 8, **kw))
        got = T.activation_fake_quant(torch.from_numpy(x), 8, **kw).numpy()
        np.testing.assert_array_equal(got, ref)


def test_bit_schedule_matches_jax():
    for args in ((8, 4, 0, 100), (8, 4, 5, 2), (8, 8, 0, 1), (8, 4, 0, 0), (6, 2, 3, 1)):
        for step in (0, 1, 2, 3, 5, 6, 7, 99, 100, 199, 200, 10_000):
            assert T.bit_schedule(step, *args) == int(J.bit_schedule(jnp.int32(step), *args))


# ------------------------------------------------------------------- masks --

def _tied(shape, seed):
    """Integer-valued weights: many equal magnitudes at any threshold."""
    return np.random.default_rng(seed).integers(-3, 4, shape).astype(np.float32)


@pytest.mark.parametrize("data", ["normal", "ties"])
@pytest.mark.parametrize("kind", ["sparse", "row", "channel", "head"])
def test_masks_match_jax(kind, data):
    make = (lambda s, seed: np.random.default_rng(seed).normal(size=s).astype(np.float32)) \
        if data == "normal" else _tied
    w = make((32, 24), 2)
    fns = {"sparse": (lambda m, x: m.sparse_mask(x, 0.3)),
           "row": (lambda m, x: m.row_mask(x, 0.5, axis=0)),
           "channel": (lambda m, x: m.channel_mask(x, 0.25, axis=-1)),
           "head": (lambda m, x: m.head_mask(x, 4, 0.5))}
    ref = np.asarray(fns[kind](J, jnp.asarray(w)))
    got = fns[kind](T, torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, ref)
    if kind == "sparse":
        k = round(w.size * 0.3)
        assert got.sum() >= k and (got.sum() > k) == (data == "ties")


def test_keep_threshold_ties_keep_more_than_k():
    scores = torch.tensor([3.0, 1.0, 2.0, 2.0, 2.0, 0.5])
    thr = T.prune._keep_threshold(scores, 0.5)             # k = 3
    assert float(thr) == 2.0 and int((scores >= thr).sum()) == 4
    assert float(J.prune._keep_threshold(jnp.asarray(scores.numpy()), 0.5)) == 2.0


# --------------------------------------------------------------- transform --

@pytest.mark.parametrize("step", [0, 1, 2, 3, 4, 5, 8])
def test_param_transform_on_tiny_matches_jax(params_np, step):
    """``build_param_transform`` on the ``tiny`` tree before and after each
    ``schedule_offset`` and across the annealing (8 bits at step 1-2, 7 at
    3-4, ... 4 from step 9), exactly: weight quantization over the whole
    stacked leaf, the masks per layer."""
    # row pruning scores a leaf by its column sums: on a quantized leaf two
    # columns' sums can be equal in exact arithmetic, and each package's fp32
    # sum breaks such a tie in its own order, so the row-pruned w_down is
    # left unquantized here
    wq = COMP["weight_quantization"]
    cfg = {"compression_training": {**COMP,
                                    "weight_quantization": {**wq, "different_groups": {
                                        "wq": {**wq["different_groups"]["wq"], "modules": [
                                            "wq", "wk", "wv", "wo", "w_gate", "w_up"]}}},
                                    "row_pruning": {
                                        "shared_parameters": {"enabled": True,
                                                              "schedule_offset": 3},
                                        "different_groups": {"rp": {
                                            "params": {"dense_ratio": 0.75},
                                            "modules": ["w_down"]}}}}}
    ref = _jax_flat(J.build_param_transform(cfg, num_heads=4)(
        jax.tree_util.tree_map(jnp.asarray, params_np), jnp.int32(step)))
    ours = T.build_param_transform(cfg, num_heads=4)(params_from_jax(params_np, device="cpu"),
                                                     step)
    got = _flat_np(ours)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    wo = got["layers/wo"].reshape(2, 4, 16, 64)
    kept = (np.abs(wo).sum(axis=(2, 3)) > 0).sum(axis=1)
    assert list(kept) == [2, 2]                      # per layer, half the heads
    if step >= 2:   # sparse: half of each layer's w_gate (ties keep more)
        assert all((got["layers/w_gate"][i] != 0).mean() >= 0.5 for i in range(2))


def test_transform_is_none_without_techniques_and_refuses_wildcards():
    assert T.build_param_transform({}) is None
    assert T.build_param_transform({"compression_training": {}}) is None
    bad = {"compression_training": {"head_pruning": {
        "shared_parameters": {"enabled": True},
        "different_groups": {"g": {"params": {}, "modules": ["*"]}}}}}
    for mod in (J, T):
        with pytest.raises(ValueError, match="must list explicit"):
            mod.build_param_transform(bad)
    for mod in (J, T):
        with pytest.raises(ValueError, match="unknown compression_training techniques"):
            mod.parse_compression_config({"compression_training": {"bogus_technique": {}}})
    no_heads = {"compression_training": {"head_pruning": {
        "shared_parameters": {"enabled": True},
        "different_groups": {"g": {"params": {}, "modules": ["wo"]}}}}}
    with pytest.raises(ValueError, match="head_pruning needs shared_parameters"):
        T.build_param_transform(no_heads)({"layers": {"wo": torch.ones(2, 8, 4)}}, 0)


# -------------------------------------------------------------- trajectory --

def _trajectory_jax(params_np, batches, cfg, lr):
    with x64():
        model = JaxCausalLM(dataclasses.replace(jtf.get_config("tiny"), dtype=jnp.float64))
        tf = J.build_param_transform(cfg, num_heads=4)
        p = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), params_np)
        losses = []
        grad = jax.jit(jax.value_and_grad(
            lambda w, b: model.loss_fn(w, b, jax.random.PRNGKey(0))))
        for step, b in enumerate(batches):
            work = tf(p, jnp.int32(step))
            loss, g = grad(work, {k: jnp.asarray(v.astype(np.int32)) for k, v in b.items()})
            losses.append(float(loss))
            p = jax.tree_util.tree_map(lambda x, d: x - lr * d, p, g)
        return losses, _jax_flat(p)


def _trajectory_port(params_np, batches, cfg, lr):
    model = CausalLM("tiny", dtype=torch.float64)
    tf = T.build_param_transform(cfg, num_heads=4)
    p = tree_map(lambda x: x.double(), params_from_jax(params_np, device="cpu"))
    losses = []
    for step, b in enumerate(batches):
        work = tree_map(lambda x: x.detach().requires_grad_(), tf(p, step))
        loss = model.loss_fn(work, {k: torch.from_numpy(v) for k, v in b.items()},
                             torch.Generator().manual_seed(0))
        grads = torch.autograd.grad(loss, tree_leaves(work))
        losses.append(float(loss))
        it = iter(grads)
        p = tree_map(lambda x: (x - lr * next(it)).detach(), p)
    return losses, _flat_np(p)


def test_fp64_qat_and_pruning_trajectory_matches_jax(params_np):
    """Five steps of QAT (8 -> 4 bits) with sparse and head pruning in
    fp64: the gradient taken at the transformed tree and applied to the
    raw one, as the JAX engine does."""
    cfg = {"compression_training": {**COMP, "weight_quantization": {
        **COMP["weight_quantization"],
        "different_groups": {"wq": {"params": {"start_bits": 8, "target_bits": 4,
                                               "quantization_period": 1},
                                    "modules": ["layers/w"]}}}}}
    batches = make_batches(5, 4)
    jl, jp = _trajectory_jax(params_np, batches, cfg, lr=0.5)
    tl, tp = _trajectory_port(params_np, batches, cfg, lr=0.5)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-6)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=1e-7, err_msg=k)


def _engine_config(stage=0, comp=COMP, opt=("adamw", 1e-2)):
    # every leaf sharded at stage 3 (tiny's leaves are all below the
    # default persistence threshold)
    zero = {"stage": stage, **({"stage3_param_persistence_threshold": 0} if stage == 3 else {})}
    return {"train_batch_size": 4, "bf16": {"enabled": True}, "steps_per_print": 10 ** 9,
            "optimizer": {"type": opt[0], "params": {"lr": opt[1]}},
            "zero_optimization": zero, "compression_training": comp}


def _jax_engine_losses(params_np, batches, config):
    with x64():
        mesh_mod.reset_mesh()
        try:
            mesh = mesh_mod.initialize_mesh(mesh_mod.MeshLayout(dp=1),
                                            devices=jax.devices()[:1])
            model = JaxCausalLM(dataclasses.replace(jtf.get_config("tiny"),
                                                    dtype=jnp.float64))
            eng, *_ = deepspeed_tpu.initialize(
                model=model, config=config, mesh=mesh,
                params=jax.tree_util.tree_map(jnp.asarray, params_np))
            return [float(eng.train_batch(batch={k: v.astype(np.int32)
                                                 for k, v in b.items()}))
                    for b in batches]
        finally:
            mesh_mod.reset_mesh()


def test_engine_first_losses_match_jax_engine(params_np):
    """The engines with head pruning from step 0 and quantization from
    step 1 (bf16 compute, fp64 activations): the first two losses."""
    batches = make_batches(2, 4)
    cfg = _engine_config()
    ref = _jax_engine_losses(params_np, batches, cfg)
    ours = _run_case({"config": cfg, "dtype": "float64"}, params_np, batches)
    np.testing.assert_allclose(ours["losses"], ref, rtol=1e-5)


ALL_AT_ZERO = {kind: {**t, "shared_parameters": {**t["shared_parameters"], "schedule_offset": 0}}
               for kind, t in COMP.items()}


@pytest.mark.parametrize("layout", ["zero3", "tp2"])
def test_sharded_compute_view_is_the_whole_leaf_transform(params_np, layout, tmp_path):
    """ZeRO-3 over 2 gloo ranks (each rank a shard of every leaf) and tp=2
    (the 'model' axis's shards): the compressed tree a step differentiates,
    gathered, equals the transform of the whole bf16 tree exactly — the
    statistics, thresholds and head scores are the whole leaf's."""
    cfg = _engine_config(stage=3 if layout == "zero3" else 1, comp=ALL_AT_ZERO)
    case = {"config": cfg, "dtype": "float64",
            **({"mesh": {"tp": 2, "dp": 1}} if layout == "tp2" else {})}
    ranks = run_ranks(2, "compress_view", tmp_path, cases=[case], params_np=params_np)
    tree = tree_map(lambda x: x.to(torch.bfloat16), params_from_jax(params_np, device="cpu"))
    want = _flat_np(tree_map(lambda x: x.float(),
                             T.build_param_transform({"compression_training": ALL_AT_ZERO},
                                                     num_heads=4)(tree, 0)))
    for rank in ranks:
        got = rank[0]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("layout", ["zero3", "tp2"])
def test_sharded_compressed_training_matches_one_device(params_np, layout, tmp_path):
    """Four steps with activation quantization too (its statistics over
    the data ranks' rows) against the one-device port engine.  tp=2 reads
    the same rows and sums the same products: every loss at rtol 1e-6.
    ZeRO-3: the first loss at rtol 1e-6 (the compressed view of the same
    weights); later steps at rtol 2e-3 — each rank's bf16 partial gradient
    is rounded before the reduce-scatter sums it, which moves the masters
    by a bf16 ulp of a gradient (as at ZeRO-3 without compression), and a
    moved master can move a fake-quant level."""
    batches = make_batches(4, 4)
    comp, sgd = {**COMP, **ACT_QUANT}, ("sgd", 0.5)
    one = _run_case({"config": _engine_config(comp=comp, opt=sgd), "dtype": "float64"},
                    params_np, batches)
    case = ({"config": _engine_config(stage=3, comp=comp, opt=sgd), "dtype": "float64"}
            if layout == "zero3" else
            {"config": _engine_config(stage=1, comp=comp, opt=sgd), "dtype": "float64",
             "mesh": {"tp": 2, "dp": 1}})
    ranks = run_ranks(2, "train", tmp_path, cases=[case], params_np=params_np,
                      batches=batches)
    for rank in ranks:
        ours = rank[0]
        np.testing.assert_allclose(ours["losses"][0], one["losses"][0], rtol=1e-6)
        if layout == "tp2":
            np.testing.assert_allclose(ours["losses"], one["losses"], rtol=1e-6)
            for k, want in one["masters"].items():
                np.testing.assert_allclose(ours["masters"][k], want, atol=1e-5, err_msg=k)
        else:
            np.testing.assert_allclose(ours["losses"], one["losses"], rtol=2e-3)


def test_eval_batch_reads_the_compressed_view(params_np):
    batch = make_batches(1, 4)[0]
    cfg = _engine_config()
    eng, *_ = ds.initialize(model=CausalLM("tiny", dtype=torch.float64), config=cfg,
                            device="cpu", params=params_from_jax(params_np, device="cpu"))
    tf = T.build_param_transform(cfg, num_heads=4)
    model = CausalLM("tiny", dtype=torch.float64)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    want = model.eval_fn(tf(eng.state.params, eng.state.step), tb)
    raw = model.eval_fn(eng.state.params, tb)
    got = eng.eval_batch(batch)
    assert float(got) == float(want) and float(got) != float(raw)


# --------------------------------------------------------- activation quant --

AQ_ATOL = 1e-3

def _act_pair(name, seed, sym, fp64=True):
    """Both models with 8-bit activation fake-quant, in fp64 (JAX under
    x64), or in fp32 (JAX's cached decode indexes its cache with int32
    slots, which x64 does not keep)."""
    jdt, tdt, ndt = ((jnp.float64, torch.float64, np.float64) if fp64
                     else (jnp.float32, torch.float32, np.float32))
    with x64() if fp64 else contextlib.nullcontext():
        jcfg = jtf.get_config(name, dtype=jdt, act_quant_bits=8, act_quant_symmetric=sym)
        jparams = jax.tree_util.tree_map(
            lambda x: np.asarray(x, ndt),
            jtf.init_params(jtf.get_config(name), jax.random.PRNGKey(seed)))
    tcfg = ttf.get_config(name, dtype=tdt, act_quant_bits=8, act_quant_symmetric=sym)
    tparams = tree_map(lambda x: x.to(tdt), params_from_jax(jparams, device="cpu"))
    return jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("name", ["tiny", "tiny-gqa", "tiny-gpt2"])
@pytest.mark.parametrize("sym", [False, True], ids=["asym", "sym"])
def test_act_quant_dense_forward_matches_jax(name, sym):
    jcfg, tcfg, jparams, tparams = _act_pair(name, 1, sym)
    tokens = np.random.RandomState(2).randint(0, 256, (2, 64)).astype(np.int32)
    with x64():
        ref = np.asarray(jtf.forward(jcfg, jax.tree_util.tree_map(jnp.asarray, jparams),
                                     jnp.asarray(tokens), attn_impl="xla",
                                     seq_sharded=False))
    out = ttf.forward(tcfg, tparams, torch.from_numpy(tokens), attn_impl="xla").numpy()
    np.testing.assert_allclose(out, ref, atol=AQ_ATOL, rtol=0)
    plain = ttf.forward(dataclasses.replace(tcfg, act_quant_bits=0), tparams,
                        torch.from_numpy(tokens), attn_impl="xla").numpy()
    assert np.abs(plain - out).max() > 2 * AQ_ATOL      # the quantization acts


def _stand_in(calls):
    def fq(x, bits, symmetric=False, static_range=None, reduce=None):
        calls.append(tuple(x.shape))
        return x * 1.125 - 0.01
    return fq


@pytest.mark.parametrize("name", ["tiny", "tiny-gpt2"])
def test_act_quant_sites_match_jax(name, monkeypatch):
    """Every site the JAX model fake-quantizes, and no other, in the dense
    forward and a cached decode: both packages' fake-quant replaced by the
    same smooth function."""
    from deepspeed_tpu.compression import quantize as jq
    from deepspeed_tpu_torch.compression import quantize as tq

    jcalls, tcalls = [], []
    monkeypatch.setattr(jq, "activation_fake_quant", _stand_in(jcalls))
    monkeypatch.setattr(tq, "activation_fake_quant", _stand_in(tcalls))
    jcfg, tcfg, jparams, tparams = _act_pair(name, 1, False)
    tokens = np.random.RandomState(2).randint(0, 256, (2, 32)).astype(np.int32)
    with x64():
        ref = np.asarray(jtf.forward(jcfg, jax.tree_util.tree_map(jnp.asarray, jparams),
                                     jnp.asarray(tokens), attn_impl="xla",
                                     seq_sharded=False))
    out = ttf.forward(tcfg, tparams, torch.from_numpy(tokens), attn_impl="xla").numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)
    jcfg, tcfg, jparams, tparams = _act_pair(name, 1, False, fp64=False)
    pos = np.broadcast_to(np.arange(32, dtype=np.int32), (2, 32))
    jl, _ = jtf.forward_cached(jcfg, jax.tree_util.tree_map(jnp.asarray, jparams),
                               jnp.asarray(tokens), jtf.init_cache(jcfg, 2, 64, dtype=jnp.float32),
                               jnp.asarray(pos), jnp.ones((2, 32), bool))
    tl, _ = ttf.forward_cached(tcfg, tparams, torch.from_numpy(tokens),
                               ttf.init_cache(tcfg, 2, 64, dtype=torch.float32, device="cpu"),
                               torch.from_numpy(pos), torch.ones((2, 32), dtype=torch.bool))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    # JAX traces its scanned layer body once: one call a site and forward
    assert len(tcalls) == tcfg.num_layers * len(jcalls) == 2 * 2 * tcfg.num_layers
    assert set(tcalls) == set(jcalls)


def test_act_quant_cached_decode_matches_jax():
    """A ragged prefill and a decode token through the KV cache (fp32)."""
    jcfg, tcfg, jparams, tparams = _act_pair("tiny", 3, False, fp64=False)
    B, S, Tn = 2, 16, 64
    tokens = np.random.RandomState(5).randint(0, 256, (B, S)).astype(np.int32)
    mask = np.ones((B, S), bool)
    mask[0, 11:] = False
    pos = np.maximum(np.cumsum(mask, axis=1) - 1, 0).astype(np.int32)
    nxt, npos = np.asarray([[7], [9]], np.int32), mask.sum(1, keepdims=True).astype(np.int32)
    jp = jax.tree_util.tree_map(jnp.asarray, jparams)
    jcache = jtf.init_cache(jcfg, B, Tn, dtype=jnp.float32)
    jl, jcache = jtf.forward_cached(jcfg, jp, jnp.asarray(tokens), jcache,
                                    jnp.asarray(pos), jnp.asarray(mask))
    jl2, _ = jtf.forward_cached(jcfg, jp, jnp.asarray(nxt), jcache, jnp.asarray(npos),
                                jnp.ones((B, 1), bool))
    tcache = ttf.init_cache(tcfg, B, Tn, dtype=torch.float32, device="cpu")
    tl, tcache = ttf.forward_cached(tcfg, tparams, torch.from_numpy(tokens), tcache,
                                    torch.from_numpy(pos), torch.from_numpy(mask))
    tl2, _ = ttf.forward_cached(tcfg, tparams, torch.from_numpy(nxt), tcache,
                                torch.from_numpy(npos), torch.ones((B, 1), dtype=torch.bool))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=AQ_ATOL, rtol=0)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=AQ_ATOL, rtol=0)


def test_act_quant_paged_tick_matches_jax():
    """One paged decode tick over three slots of one batch (the per-tensor
    statistics span every slot of the tick, as in JAX)."""
    jcfg, tcfg, jparams, tparams = _act_pair("tiny", 4, False)
    rs = np.random.RandomState(6)
    table = np.zeros((3, 4), np.int32)
    table[0, :2], table[1, :2], table[2, :1] = [3, 5], [1, 2], [7]
    with x64():
        jp = jax.tree_util.tree_map(jnp.asarray, jparams)
        jcache = jtf.init_paged_cache(jcfg, 9, 8, dtype=jnp.float64)
    tcache = pool_from_jax(jax.tree_util.tree_map(np.asarray, jcache), "cpu")
    lengths = np.array([11, 9, 5], np.int32)
    prompt = np.zeros((3, 16), np.int32)
    for r, n in enumerate(lengths):
        prompt[r, :n] = rs.randint(1, 250, n)
    steps = [(prompt, np.zeros(3, np.int32), np.arange(16)[None] < lengths[:, None]),
             (rs.randint(1, 250, (3, 1)).astype(np.int32), lengths, np.ones((3, 1), bool))]
    for tokens, start, smask in steps:
        with x64():
            jl, jcache = jtf.forward_paged(jcfg, jp, jnp.asarray(tokens), jcache,
                                           jnp.asarray(table), jnp.asarray(start),
                                           jnp.asarray(smask))
        tl, tcache = ttf.forward_paged(tcfg, tparams, torch.from_numpy(tokens), tcache,
                                       torch.from_numpy(table), torch.from_numpy(start),
                                       torch.from_numpy(smask))
        keep = np.broadcast_to(smask[..., None], np.asarray(jl).shape)
        np.testing.assert_allclose(np.where(keep, tl.numpy(), 0),
                                   np.where(keep, np.asarray(jl), 0), atol=AQ_ATOL, rtol=0)


# --------------------------------------------------- cleanup and refusals --

HEAD_ROW = {"compression_training": {
    "row_pruning": {"shared_parameters": {"enabled": True},
                    "different_groups": {"g": {"params": {"dense_ratio": 0.5},
                                               "modules": ["w_gate", "w_up", "w_down"]}}},
    "head_pruning": {"shared_parameters": {"enabled": True},
                     "different_groups": {"g": {"params": {"dense_ratio": 0.5},
                                                "modules": ["wo"]}}},
    "layer_reduction": {"enabled": True, "keep_number_layer": 1}}}


@pytest.mark.parametrize("name", ["tiny", "tiny-gqa"])
def test_redundancy_clean_and_student_init_match_jax(name):
    cfg = jtf.get_config(name)
    params_np = jax.tree_util.tree_map(lambda x: np.array(x),
                                       jtf.init_params(cfg, jax.random.PRNGKey(8)))
    # ties in the scores: two heads of layer 0 made equal
    params_np["layers"]["wo"][0, 16:32] = params_np["layers"]["wo"][0, :16]
    jclean, jdims = J.redundancy_clean(jax.tree_util.tree_map(jnp.asarray, params_np),
                                       HEAD_ROW, num_heads=cfg.num_heads)
    tclean, tdims = T.redundancy_clean(params_from_jax(params_np, device="cpu"), HEAD_ROW,
                                       num_heads=cfg.num_heads)
    assert tdims == jdims
    ref, got = _jax_flat(jclean), _flat_np(tclean)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    if cfg.kv_heads != cfg.num_heads:   # GQA keeps its KV heads
        assert got["layers/wk"].shape == params_np["layers"]["wk"].shape
    jst = _jax_flat(J.student_initialization(jclean, HEAD_ROW))
    tst = _flat_np(T.student_initialization(tclean, HEAD_ROW))
    for k in jst:
        np.testing.assert_array_equal(tst[k], jst[k], err_msg=k)
    lr = {"compression_training": {"layer_reduction": {"enabled": True,
                                                       "teacher_layer": [1]}}}
    np.testing.assert_array_equal(
        _flat_np(T.student_initialization(tclean, lr))["layers/wq"],
        _jax_flat(J.student_initialization(jclean, lr))["layers/wq"])
    for mod in (J, T):
        with pytest.raises(ValueError, match="layer_reduction is not enabled"):
            mod.student_initialization(params_np, {})


def _refusal_cases():
    comp = {"compression_training": COMP}
    bf16 = {"train_batch_size": 2, "bf16": {"enabled": True}}
    aq = ACT_QUANT["activation_quantization"]
    return {
        "zero_one_adam": ({**bf16, **comp, "optimizer": {"type": "ZeroOneAdam",
                                                         "params": {"lr": 1e-3}}},
                          "ZeroOneAdam \\+ compression_training"),
        "fp32_compute": ({"train_batch_size": 2, **comp},
                         "compression_training with fp32 compute"),
        "act_quant_two_bits": ({**bf16, "compression_training": {"activation_quantization": {
            **aq, "different_groups": {"a": {"params": {"bits": 8}, "modules": ["*"]},
                                       "b": {"params": {"bits": 4}, "modules": ["*"]}}}}},
            "applied model-wide"),
        "act_quant_offset": ({**bf16, "compression_training": {"activation_quantization": {
            **aq, "shared_parameters": {**aq["shared_parameters"], "schedule_offset": 3}}}},
            "schedule_offset is not"),
        "act_quant_static": ({**bf16, "compression_training": {"activation_quantization": {
            **aq, "shared_parameters": {**aq["shared_parameters"],
                                        "range_calibration": "static"}}}},
            "static range calibration"),
    }


@pytest.mark.parametrize("case", sorted(_refusal_cases()))
def test_refusals_match_jax(case, params_np):
    """Each composition the JAX engine refuses, with its words (the JAX
    engine's fp32 refusal comes at its first step)."""
    config, match = _refusal_cases()[case]
    with pytest.raises(NotImplementedError, match=match):
        ds.initialize(model=CausalLM("tiny", dtype=torch.float32), config=config,
                      device="cpu", params=params_from_jax(params_np, device="cpu"))
    with x64():
        mesh_mod.reset_mesh()
        try:
            mesh = mesh_mod.initialize_mesh(mesh_mod.MeshLayout(dp=1),
                                            devices=jax.devices()[:1])
            with pytest.raises(NotImplementedError, match=match):
                eng, *_ = deepspeed_tpu.initialize(
                    model=JaxCausalLM("tiny"), config=config, mesh=mesh,
                    params=jax.tree_util.tree_map(jnp.asarray, params_np))
                eng.train_batch(batch={"input_ids": np.zeros((2, 16), np.int32)})
        finally:
            mesh_mod.reset_mesh()


def test_offload_and_pipeline_refusals(tmp_path):
    comp = {"compression_training": COMP}
    base = {"train_batch_size": 2, "bf16": {"enabled": True}, **comp}
    cases = [
        ({**base, "zero_optimization": {"stage": 3, "offload_param": {
            "device": "nvme", "nvme_path": str(tmp_path)}}},
         "offload_param \\+ compression_training: unsupported", {}),
        ({**base, "zero_optimization": {"stage": 1, "offload_optimizer": {
            "device": "nvme", "nvme_path": str(tmp_path)}}},
         "compression_training with host-stepped optimizer offload", {}),
        ({**base, "train_batch_size": 4},
         "pipeline_schedule='1f1b' \\+ compression_training",
         {"pipeline_stages": 2, "pipeline_schedule": "1f1b"}),
    ]
    for config, match, model_kw in cases:
        with pytest.raises(NotImplementedError, match=match):
            ds.initialize(model=CausalLM("tiny", dtype=torch.bfloat16, **model_kw),
                          config=config, device="cpu")
    # an activation-quant block needs a model that takes it
    with pytest.raises(NotImplementedError, match="act_quant_bits"):
        ds.initialize(model=None, loss_fn=lambda p, b, g: p["w"].sum(),
                      params={"w": torch.ones(2, 2)}, device="cpu",
                      config={"train_batch_size": 1, "bf16": {"enabled": True},
                              "compression_training": ACT_QUANT})


def test_gpipe_compressed_step_runs_the_transform():
    """A GPipe pipeline (virtual stages) takes the compressed tree too: its
    first loss equals the un-pipelined engine's."""
    batch = make_batches(1, 4)[0]
    cfg = {**_engine_config(), "train_batch_size": 4}
    losses = []
    for kw in ({}, {"pipeline_stages": 2}):
        eng, *_ = ds.initialize(model=CausalLM("tiny", dtype=torch.float64, **kw),
                                config=cfg, device="cpu", params=params_from_jax(
                                    jax.tree_util.tree_map(np.asarray, jtf.init_params(
                                        jtf.get_config("tiny"), jax.random.PRNGKey(0))),
                                    device="cpu"))
        losses.append(float(eng.train_batch(batch=batch)))
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-6)


def test_pipe_axis_is_refused(params_np, tmp_path):
    """Not ported: compression with a 'pipe' axis above 1 (ROADMAP item
    11), whose stage leaves would take their statistics over one stage."""
    case = {"config": {**_engine_config(), "train_batch_size": 4}, "dtype": "float64",
            "mesh": {"pp": 2}, "model_kw": {"pipeline_stages": 2}}
    with pytest.raises(AssertionError, match="'pipe' or 'expert' axis above 1"):
        run_ranks(2, "train", tmp_path, cases=[case], params_np=params_np,
                  batches=make_batches(1, 4))
