"""The port's data-parallel trainer against the JAX engine: ZeRO stages 0-3
and MiCS over gloo ranks on the CPU.

The port runs as separate processes (``tests/_torch_ranks.py``, which
imports no jax), 2 and 4 gloo ranks, every stage of one world size in one
spawn.  The JAX engine runs in this process on 2 or 4 of the virtual
devices of tests/conftest.py under x64, at the same data-parallel degree
and stage.  Model: ``tiny`` with fp64 activations; the port trains fp64
weights, the JAX engine casts its initial tree to fp32 masters (its
``engine.py:492``), so, as in ``test_torch_golden_parity.py``, the two
agree to the rounding of fp32 weights and of the fp32 loss and gradient
accumulation both keep: losses and final weights at rtol 5e-6 / atol
5e-6, the golden gate's tolerance.  The data: 4 steps of gas 2 over the
same global batches of 8 rows, the labels with a different count of
ignored positions in every row (so the ranks hold unequal counts of
labelled tokens and only the global mean matches JAX), AdamW with weight
decay, and clipping at 0.05, below every step's gradient norm (checked).

The port's own contracts, at the same tolerance-free or stated bounds:
- its dp=N run equals its one-process run on the same global batches
  (rtol/atol 1e-6: the fp32 gradient accumulation and loss, summed in
  another order; observed differences are ~3e-7), with dropout on too
  (the masks are keyed by the global row);
- an inf planted in one rank's gradient (an fp16 run) makes every rank
  skip the step (its masters bit-unchanged) and halve the loss scale;
- frozen parameters stay bit-equal to their initial values at stages 2
  and 3;
- placements: stage 1 keeps the compute params whole and the masters and
  moments 1/N; stage 3 shards the compute params 1/N except the leaves
  under ``stage3_param_persistence_threshold``; MiCS at 4 ranks with shard
  size 2 shards 1/2 and replicates across 'data_outer'.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import deepspeed_tpu
from deepspeed_tpu.models import CausalLM as JaxCausalLM
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.parallel import mesh as mesh_mod

from ._torch_ranks import _run_case, make_batches, run_ranks

TOL = dict(rtol=5e-6, atol=5e-6)
SELF_TOL = dict(rtol=1e-6, atol=1e-6)
STEPS, TRAIN_BATCH, GAS, CLIP = 4, 8, 2, 0.05


def _config(stage, mics=-1, threshold=0, **extra):
    cfg = {"train_batch_size": TRAIN_BATCH, "gradient_accumulation_steps": GAS,
           "gradient_clipping": CLIP,
           "optimizer": {"type": "adamw",
                         "params": {"lr": 1e-3, "weight_decay": 0.1,
                                    "mu_dtype": "float64", "nu_dtype": "float64"}},
           "zero_optimization": {"stage": stage, "mics_shard_size": mics,
                                 "stage3_param_persistence_threshold": threshold},
           "steps_per_print": 10 ** 9}
    cfg.update(extra)
    return cfg


@pytest.fixture(scope="module")
def params_np():
    jcfg = jtf.get_config("tiny")
    return jax.tree_util.tree_map(np.asarray,
                                  jtf.init_params(jcfg, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def batches():
    return make_batches(STEPS, TRAIN_BATCH)


def _jax_run(params_np, batches, dp, stage, mics=-1):
    """The JAX engine at ``dp`` devices (MiCS: data=mics x data_outer)."""
    jax.config.update("jax_enable_x64", True)
    try:
        mesh_mod.reset_mesh()
        layout = (mesh_mod.MeshLayout(dp=dp) if mics <= 0
                  else mesh_mod.MeshLayout(dp=mics, dp_outer=dp // mics))
        mesh = mesh_mod.initialize_mesh(layout, devices=jax.devices()[:dp])
        model = JaxCausalLM(dataclasses.replace(jtf.get_config("tiny"),
                                                dtype=jnp.float64))
        eng, *_ = deepspeed_tpu.initialize(
            model=model, config=_config(stage, mics),
            params=jax.tree_util.tree_map(jnp.asarray, params_np), mesh=mesh)
        losses, norms = [], []
        for b in batches:
            losses.append(float(eng.train_batch(batch={
                k: v.astype(np.int32) for k, v in b.items()})))
            norms.append(float(eng.get_global_grad_norm()))
        flat = jax.tree_util.tree_flatten_with_path(eng.get_params())[0]
        params = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
                  for path, x in flat}
    finally:
        jax.config.update("jax_enable_x64", False)
        mesh_mod.reset_mesh()
    return {"losses": losses, "grad_norms": norms, "params": params}


@pytest.fixture(scope="module")
def one_process(params_np, batches):
    """The port without a process group: the one-device trainer."""
    return _run_case({"config": _config(0)}, params_np, batches)


CASES = {2: [(s, -1) for s in range(4)],
         4: [(s, -1) for s in range(4)] + [(3, 2)]}


@pytest.fixture(scope="module", params=[2, 4], ids=lambda w: f"dp{w}")
def dp_run(request, params_np, batches, tmp_path_factory):
    world = request.param
    cases = [{"config": _config(s, mics)} for s, mics in CASES[world]]
    ranks = run_ranks(world, "train", tmp_path_factory.mktemp("zero"),
                      cases=cases, params_np=params_np, batches=batches)
    return world, ranks


def _check_against(ours, losses, params, tol):
    np.testing.assert_allclose(ours["losses"], losses, **tol)
    assert set(ours["masters"]) == set(params)
    for k, want in params.items():
        np.testing.assert_allclose(ours["masters"][k], want, err_msg=k, **tol)


def test_stages_match_jax_engine(dp_run, params_np, batches):
    """Losses and final weights of every stage (and MiCS at 4 ranks) match
    the JAX engine at the same dp and stage; clipping was active on every
    step; every rank reports the same global loss and gathers the same
    weights."""
    world, ranks = dp_run
    for i, (stage, mics) in enumerate(CASES[world]):
        ref = _jax_run(params_np, batches, world, stage, mics)
        ours = ranks[0][i]
        assert ours["dp_world"] == world
        _check_against(ours, ref["losses"], ref["params"], TOL)
        np.testing.assert_allclose(ours["grad_norms"], ref["grad_norms"], rtol=1e-5)
        assert min(ours["grad_norms"]) > CLIP, "clipping must be active"
        for other in ranks[1:]:
            assert other[i]["losses"] == ours["losses"]
            for k, v in ours["masters"].items():
                np.testing.assert_array_equal(other[i]["masters"][k], v)


def test_dp_matches_one_process(dp_run, one_process):
    """dp=N over the same global batches equals the one-process trainer,
    whatever each rank's share of ignored labels."""
    world, ranks = dp_run
    for i, _ in enumerate(CASES[world]):
        _check_against(ranks[0][i], one_process["losses"], one_process["masters"],
                       SELF_TOL)


def test_placements(dp_run):
    """Stage 0 keeps everything whole; stages 1-3 shard the masters (and the
    moments) 1/N on the planned dim; stage 3 the compute params too; MiCS
    (4 ranks, shard size 2) shards 1/2 and replicates across 'data_outer'."""
    world, ranks = dp_run
    full = ranks[0][0]["master_shapes"]
    for i, (stage, mics) in enumerate(CASES[world]):
        n = world if mics <= 0 else mics
        for rank in ranks:
            got = rank[i]
            assert got["moment_shapes"] == got["master_shapes"]
            for k, shape in got["master_shapes"].items():
                if stage == 0:
                    assert shape == full[k]
                else:
                    assert np.prod(shape) * n == np.prod(full[k]), (k, shape)
            if stage == 3:   # fp64: the params are the masters
                assert got["param_shapes"] == got["master_shapes"]
        if mics > 0:   # same data index => same shard
            by_data = {}
            for rank in ranks:
                got = rank[i]
                ref = by_data.setdefault(got["axis_data"], got)
                for k, v in got["local_masters"].items():
                    np.testing.assert_array_equal(v, ref["local_masters"][k])
            assert len(by_data) == mics


def _bf16_config(stage, threshold=0):
    cfg = _config(stage, threshold=threshold, bf16={"enabled": True})
    cfg["optimizer"]["params"] = {"lr": 1e-3}
    return cfg


def _fp16_config(stage):
    cfg = _config(stage, fp16={"enabled": True, "initial_scale_power": 8,
                               "hysteresis": 1})
    cfg["optimizer"]["params"] = {"lr": 1e-3}
    return cfg


@pytest.fixture(scope="module")
def contracts_run(params_np, batches, tmp_path_factory):
    """Two spawns at 2 ranks: bf16 placements, frozen parameters and dropout
    on the usual batches; the planted overflow on batches whose rank-1 rows
    carry an inf on the second step."""
    cases = [
        {"config": _bf16_config(1), "dtype": "bfloat16"},
        {"config": _bf16_config(3, threshold=5000), "dtype": "bfloat16"},
        {"config": _config(2), "model_kw": {"frozen_keywords": ("embed",)}},
        {"config": _config(3), "model_kw": {"frozen_keywords": ("embed",)}},
        {"config": _config(0), "model_kw": {"dropout": 0.1}},
        {"config": _config(3), "model_kw": {"dropout": 0.1}},
        {"config": _config(2), "loop": True},
        {"config": _config(3), "loop": True},
        {"config": _config(2)},
        {"config": _config(3)},
    ]
    planted = [dict(b, plant=np.zeros(TRAIN_BATCH, np.int64)) for b in batches[:3]]
    planted[1]["plant"][2:4] = 1   # micro-batch 0's rows on rank 1 only
    fp16_cases = [{"config": _fp16_config(s), "dtype": "float16", "plant_inf": True}
                  for s in (2, 3)]
    tmp = tmp_path_factory.mktemp("contracts")
    ranks = run_ranks(2, "train", tmp, cases=cases, params_np=params_np, batches=batches)
    fp16 = run_ranks(2, "train", tmp, cases=fp16_cases, params_np=params_np,
                     batches=planted)
    return cases, ranks, fp16


def test_bf16_placements(contracts_run):
    """bf16 over fp32 masters at 2 ranks.  Stage 1: compute params whole,
    masters and moments halved.  Stage 3, threshold 5000: the compute params
    halved except the leaves under 5000 elements, which stay whole; the
    masters halved whatever their size."""
    _, ranks, _ = contracts_run
    for rank in ranks:
        s1, s3 = rank[0], rank[1]
        full = s1["params_full_shapes"]
        assert s1["param_shapes"] == full
        for k, shape in s1["master_shapes"].items():
            assert 2 * np.prod(shape) == np.prod(full[k])
            assert s1["moment_shapes"][k] == shape
        small = {k for k, v in full.items() if np.prod(v) < 5000}
        assert small and small != set(full)
        for k, shape in s3["param_shapes"].items():
            assert (shape == full[k]) == (k in small), k
            assert 2 * np.prod(s3["master_shapes"][k]) == np.prod(full[k])
        assert np.isfinite(s1["losses"]).all()
        # the same algorithm; bf16 gradients reduced in another order
        np.testing.assert_allclose(s3["losses"], s1["losses"], rtol=1e-3)


def test_overflow_skips_on_every_rank(contracts_run):
    """fp16 at stages 2 and 3: an inf planted in rank 1's gradient of one
    embedding element lands in one rank's shard only; every rank skips that
    step (its masters bit-unchanged) and halves the loss scale."""
    _, _, fp16 = contracts_run
    for i in range(2):
        for rank in fp16:
            got = rank[i]
            assert got["skipped"] == 1
            assert got["loss_scales"] == [256.0, 128.0, 128.0]
            assert got["local_master_sums"][1] == got["local_master_sums"][0]
            assert got["local_master_sums"][2] != got["local_master_sums"][1]


def test_frozen_parameters_stay_put(contracts_run, params_np):
    """Stages 2 and 3: the frozen embedding is bit-equal to its initial
    value after 4 steps; the other leaves moved."""
    _, ranks, _ = contracts_run
    for rank in ranks:
        for got in rank[2:4]:
            np.testing.assert_array_equal(got["masters"]["embed"],
                                          params_np["embed"].astype(np.float64))
            assert not np.array_equal(got["masters"]["layers/wq"],
                                      params_np["layers"]["wq"].astype(np.float64))


def test_dropout_dp_matches_one_process(contracts_run, params_np, batches):
    """Dropout 0.1 at 2 ranks (stages 0 and 3) equals the one-process run:
    each row's mask is keyed by its global index."""
    cases, ranks, _ = contracts_run
    ref = _run_case(cases[4], params_np, batches)
    for got in ranks[0][4:6]:
        _check_against(got, ref["losses"], ref["masters"], SELF_TOL)
    assert ref["losses"] != ranks[0][2]["losses"]   # the masks did something


def test_forward_backward_step_equals_train_batch(contracts_run):
    """Stages 2 and 3 at 2 ranks through ``forward``/``backward``/``step``
    (each rank's ``forward`` takes the global micro-batch and returns its
    global loss) equal ``train_batch``, losses and masters bit for bit."""
    _, ranks, _ = contracts_run
    for rank in ranks:
        for got, want in zip(rank[6:8], rank[8:10]):
            assert got["losses"] == want["losses"]
            for k, v in want["masters"].items():
                np.testing.assert_array_equal(got["masters"][k], v)
