"""The port's curriculum learning and data pipeline
(``deepspeed_tpu_torch/runtime/data_pipeline``, the engine's wiring in
``runtime/features.py``) against the JAX package's.

- the curriculum schedules (fixed_linear, fixed_root, fixed_discrete,
  custom) value for value over 40 steps;
- the samplers' index streams (the legacy ``CurriculumBatchSampler`` and
  the multi-metric cluster sampler) equal to JAX's index for index, and
  their state round-trips: a sampler loaded from another's state goes on
  with the same stream;
- ``MMapIndexedDataset`` files written by one package read by the other;
  the ``DataAnalyzer`` map/reduce files equal, each package reducing the
  other's map;
- the legacy seqlen curriculum's engine trajectory (fp64 ``tiny``,
  truncated windows) against the JAX engine's: losses at rtol/atol 5e-6,
  the final weights too but for at most 0.1% of a leaf's elements, which
  stay within atol 1e-4 (the JAX engine keeps fp32 masters, and Adam
  divides an element's gradient by its own magnitude: a gradient at the
  level of the rounding moves by a rounding-dependent share of the step,
  tests/test_torch_training.py's rule); and the multi-metric
  curriculum's engine stream against JAX's;
- a metric curriculum survives a checkpoint: the resumed engine trains
  the uninterrupted run's batches, bit for bit;
- the JAX engine's refusals, message for message.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
from deepspeed_tpu.models import CausalLM as JaxCausalLM
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.parallel import mesh as mesh_mod
from deepspeed_tpu.runtime import data_pipeline as jdp

import deepspeed_tpu_torch as ds
from deepspeed_tpu_torch.models import CausalLM
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.runtime import data_pipeline as tdp

torch.set_num_threads(1)

TOL = dict(rtol=5e-6, atol=5e-6)
S = 32

SCHEDULES = {
    "fixed_linear": {"schedule_type": "fixed_linear", "schedule_config": {
        "total_curriculum_step": 20, "difficulty_step": 8}},
    "fixed_root": {"schedule_type": "fixed_root", "schedule_config": {
        "total_curriculum_step": 25, "difficulty_step": 4, "root_degree": 2}},
    "fixed_discrete": {"schedule_type": "fixed_discrete", "schedule_config": {
        "difficulty": [8, 16, 32], "max_step": [5, 12]}},
    "custom": {"schedule_type": "custom", "schedule_config": {}},
}


def _sched_cfg(kind):
    return {"curriculum_type": "seqlen", "min_difficulty": 8, "max_difficulty": 64,
            **SCHEDULES[kind]}


@pytest.mark.parametrize("kind", list(SCHEDULES))
def test_curriculum_schedules_match_jax(kind):
    ours = tdp.CurriculumScheduler(_sched_cfg(kind))
    theirs = jdp.CurriculumScheduler(_sched_cfg(kind))
    if kind == "custom":
        fn = lambda step: 8 + 3 * step   # noqa: E731
        ours.set_custom_get_difficulty(fn)
        theirs.set_custom_get_difficulty(fn)
    got = [ours.update_difficulty(s) for s in range(40)]
    want = [theirs.update_difficulty(s) for s in range(40)]
    assert got == want
    assert ours.get_state() == theirs.get_state()


def test_curriculum_config_errors_match_jax():
    for bad in ({"curriculum_type": "seqlen", "min_difficulty": 1, "max_difficulty": 2,
                 "schedule_type": "fixed_linear", "schedule_config": {}},
                {"curriculum_type": "seqlen", "min_difficulty": 1, "max_difficulty": 2,
                 "schedule_type": "nope"}):
        with pytest.raises(ValueError) as a:
            tdp.CurriculumScheduler(bad)
        with pytest.raises(ValueError) as b:
            jdp.CurriculumScheduler(bad)
        assert str(a.value) == str(b.value)


def _metric_values(n=64, seed=0):
    rs = np.random.RandomState(seed)
    return rs.randint(4, 60, n).astype(np.float64), rs.rand(n)


def _multi(pkg, values):
    a, b = values
    return pkg.MultiMetricCurriculumSampler({
        "len": {"values": a, "scheduler": pkg.CurriculumScheduler({
            **_sched_cfg("fixed_linear"), "curriculum_type": "len",
            "min_difficulty": 16})},
        "p": {"values": b, "difficulty_type": "percentile", "scheduler":
              pkg.CurriculumScheduler({"curriculum_type": "p", "min_difficulty": 30,
                                       "max_difficulty": 100,
                                       "schedule_type": "fixed_linear",
                                       "schedule_config": {"total_curriculum_step": 10,
                                                           "difficulty_step": 10}})}},
        batch_size=4, seed=7)


def _legacy(pkg, values):
    return pkg.CurriculumBatchSampler(values[0], batch_size=4, seed=3,
                                      curriculum=pkg.CurriculumScheduler({
                                          **_sched_cfg("fixed_linear"),
                                          "curriculum_type": "len",
                                          "min_difficulty": 16}))


@pytest.mark.parametrize("make", [_legacy, _multi], ids=["legacy", "multi_metric"])
def test_sampler_streams_and_state_match_jax(make):
    values = _metric_values()
    ours, theirs = make(tdp, values), make(jdp, values)
    it_o, it_t = iter(ours), iter(theirs)
    for _ in range(30):
        assert next(it_o) == next(it_t)
    assert ours.state_dict()["consumed_batches"] == 30
    # a sampler restored from the state goes on with the same stream
    if make is _multi:
        back = make(tdp, values)
        back.load_state_dict(ours.state_dict())
        it_b = iter(back)
        for _ in range(10):
            assert next(it_b) == next(it_o) == next(it_t)


def test_indexed_dataset_files_cross_packages(tmp_path):
    rs = np.random.RandomState(1)
    docs = [rs.randint(0, 1000, rs.randint(1, 40)).astype(np.int32) for _ in range(12)]
    for writer, reader, name in ((tdp, jdp, "port"), (jdp, tdp, "jax")):
        b = writer.MMapIndexedDatasetBuilder(str(tmp_path / f"{name}.bin"), dtype=np.int32)
        for d in docs:
            b.add_item(d)
        b.finalize(str(tmp_path / f"{name}.idx"))
        ds_ = reader.MMapIndexedDataset(str(tmp_path / name))
        assert len(ds_) == len(docs)
        np.testing.assert_array_equal(ds_.sizes, [len(d) for d in docs])
        for got, want in zip(ds_[:], docs):
            np.testing.assert_array_equal(got, want)
    assert (tmp_path / "port.idx").read_bytes() == (tmp_path / "jax.idx").read_bytes()
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes()


def test_data_analyzer_map_reduce_match_jax(tmp_path):
    rs = np.random.RandomState(2)
    data = [{"input_ids": rs.randint(0, 9, rs.randint(1, 30))} for _ in range(37)]
    metrics = {"seqlen": lambda s: float(len(s["input_ids"])),
               "vocab": lambda s: float(len(set(s["input_ids"].tolist())))}
    for mapper, reducer, name in ((tdp, jdp, "a"), (jdp, tdp, "b")):
        out = str(tmp_path / name)
        m = mapper.DataAnalyzer(metrics=metrics, num_workers=3, run_id="r")
        for w in range(3):
            m.run_map(data, out, worker_id=w)
        r = reducer.DataAnalyzer(metrics=metrics, num_workers=3, run_id="r")
        for metric in metrics:
            r.run_reduce(out, metric)
    for metric in metrics:
        a = tdp.load_metric_values(str(tmp_path / "a"), metric)
        b = jdp.load_metric_values(str(tmp_path / "b"), metric)
        np.testing.assert_array_equal(a, b)
    got = tdp.DataAnalyzer(metrics=metrics, num_workers=2).run_multi(data, str(tmp_path / "c"))
    want = jdp.DataAnalyzer(metrics=metrics, num_workers=2).run_multi(data, str(tmp_path / "d"))
    for metric in metrics:
        np.testing.assert_array_equal(got[metric], want[metric])


# ---------------------------------------------------------------------------
# The engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def params_np():
    return jax.tree_util.tree_map(
        np.asarray, jtf.init_params(jtf.get_config("tiny"), jax.random.PRNGKey(8)))


def _config(**extra):
    return {"train_batch_size": 4, "gradient_accumulation_steps": 2,
            "gradient_clipping": 0.5, "seed": 11,
            "optimizer": {"type": "adamw", "params": {"lr": 2e-3, "weight_decay": 0.01}},
            "steps_per_print": 10 ** 9, **extra}


def _jax_engine(params_np, config, training_data=None):
    mesh = mesh_mod.initialize_mesh(mesh_mod.MeshLayout(dp=1), devices=jax.devices()[:1])
    model = JaxCausalLM(dataclasses.replace(jtf.get_config("tiny", max_seq_len=S),
                                            dtype=jnp.float64))
    eng, *_ = deepspeed_tpu.initialize(
        model=model, config=config, training_data=training_data,
        params=jax.tree_util.tree_map(jnp.asarray, params_np), mesh=mesh)
    return eng


def _port_engine(params_np, config, training_data=None):
    params = {k: v for k, v in params_from_jax(params_np, device="cpu").items()}
    from deepspeed_tpu_torch.utils.tree import tree_map

    eng, *_ = ds.initialize(model=CausalLM("tiny", dtype=torch.float64, max_seq_len=S),
                            config=config, training_data=training_data, device="cpu",
                            params=tree_map(lambda x: x.double(), params))
    return eng


def _x64(fn):
    jax.config.update("jax_enable_x64", True)
    mesh_mod.reset_mesh()
    try:
        return fn()
    finally:
        jax.config.update("jax_enable_x64", False)
        mesh_mod.reset_mesh()


SEQLEN = {"curriculum_learning": {
    "enabled": True, "curriculum_type": "seqlen", "min_difficulty": 8,
    "max_difficulty": S, "schedule_type": "fixed_linear",
    "schedule_config": {"total_curriculum_step": 3, "difficulty_step": 8}}}


def test_seqlen_curriculum_trajectory_matches_jax(params_np):
    rs = np.random.RandomState(12)
    batches = [{"input_ids": rs.randint(0, 256, (4, S)).astype(np.int32)}
               for _ in range(5)]

    def jax_run():
        eng = _jax_engine(params_np, _config(**SEQLEN))
        out = [float(eng.train_batch(batch=b)) for b in batches]
        flat = jax.tree_util.tree_flatten_with_path(eng.get_params())[0]
        return out, eng.curriculum_scheduler.get_current_difficulty(), {
            "/".join(str(getattr(k, "key", k)) for k in p): np.asarray(x) for p, x in flat}

    want, want_diff, want_params = _x64(jax_run)
    eng = _port_engine(params_np, _config(**SEQLEN))
    diffs = []
    got = []
    for b in batches:
        got.append(float(eng.train_batch(batch=b)))
        diffs.append(eng.curriculum_scheduler.get_current_difficulty())
    assert diffs == [16, 24, 32, 32, 32] and diffs[-1] == want_diff
    np.testing.assert_allclose(got, want, **TOL)
    from deepspeed_tpu_torch.utils.tree import tree_flatten_with_path

    for path, x in tree_flatten_with_path(eng.get_params()):
        a, b = x.numpy(), want_params[path]
        np.testing.assert_allclose(a, b, err_msg=path, rtol=5e-6, atol=1e-4)
        assert (~np.isclose(a, b, **TOL)).mean() <= 1e-3, path


def _dataset(n=48, seed=13):
    rs = np.random.RandomState(seed)
    return [{"input_ids": rs.randint(0, 256, S).astype(np.int32)} for _ in range(n)]


def _multi_cfg(tmp_path, data):
    lens = np.asarray([int(d["input_ids"][0]) % 50 + 1 for d in data], np.float64)
    path = str(tmp_path / "len_values.npy")
    np.save(path, lens)
    return {"data_efficiency": {"enabled": True, "data_sampling": {
        "enabled": True, "curriculum_learning": {"enabled": True, "curriculum_metrics": {
            "len": {"metric_values_path": path, "min_difficulty": 20,
                    "max_difficulty": 50, "schedule_type": "fixed_linear",
                    "schedule_config": {"total_curriculum_step": 6,
                                        "difficulty_step": 5}}}}}}}


def test_metric_curriculum_engine_stream_matches_jax(params_np, tmp_path):
    data = _dataset()
    cfg = _config(**_multi_cfg(tmp_path, data))

    def jax_stream():
        eng = _jax_engine(params_np, cfg, training_data=data)
        it = iter(eng.training_dataloader)
        return [next(it)["input_ids"] for _ in range(6)]

    want = _x64(jax_stream)
    eng = _port_engine(params_np, cfg, training_data=data)
    it = iter(eng.training_dataloader)
    for w in want:
        np.testing.assert_array_equal(next(it)["input_ids"], w)


def test_metric_curriculum_resumes_bit_exact(params_np, tmp_path):
    data = _dataset()
    cfg = _config(**_multi_cfg(tmp_path, data))
    ref = _port_engine(params_np, cfg, training_data=data)
    for _ in range(3):
        ref.train_batch()
    ref.save_checkpoint(str(tmp_path / "ckpt"), tag="t")
    want = [float(ref.train_batch()) for _ in range(3)]
    state = ref.training_dataloader.data_sampler.state_dict()
    new = _port_engine(params_np, cfg, training_data=data)
    new.load_checkpoint(str(tmp_path / "ckpt"), tag="t")
    got = [float(new.train_batch()) for _ in range(3)]
    assert got == want
    assert new.training_dataloader.data_sampler.state_dict()["consumed_batches"] == \
        state["consumed_batches"]


def test_legacy_curriculum_state_rides_the_checkpoint(params_np, tmp_path):
    eng = _port_engine(params_np, _config(**SEQLEN))
    rs = np.random.RandomState(3)
    for _ in range(2):
        eng.train_batch(batch={"input_ids": rs.randint(0, 256, (4, S))})
    eng.save_checkpoint(str(tmp_path / "c"), tag="t")
    new = _port_engine(params_np, _config(**SEQLEN))
    new.load_checkpoint(str(tmp_path / "c"), tag="t")
    assert new.curriculum_scheduler.get_state() == eng.curriculum_scheduler.get_state()


def _refusal(config, training_data=None):
    def jax_err():
        try:
            _jax_engine(_tiny_np(), config, training_data)
        except Exception as e:   # noqa: BLE001
            return e
        return None

    theirs = _x64(jax_err)
    assert theirs is not None
    with pytest.raises(type(theirs)) as ours:
        _port_engine(_tiny_np(), config, training_data)
    assert str(theirs) in str(ours.value) or str(ours.value) in str(theirs), \
        (str(theirs), str(ours.value))


def _tiny_np():
    return jax.tree_util.tree_map(
        np.asarray, jtf.init_params(jtf.get_config("tiny"), jax.random.PRNGKey(0)))


def test_refusal_metric_curriculum_without_values():
    _refusal(_config(curriculum_learning={
        "enabled": True, "curriculum_type": "vocab_rarity", "min_difficulty": 1,
        "max_difficulty": 9, "schedule_type": "fixed_linear",
        "schedule_config": {"total_curriculum_step": 3, "difficulty_step": 1}}))


def test_refusal_legacy_and_data_efficiency_curricula(tmp_path):
    data = _dataset()
    np.save(str(tmp_path / "v.npy"), np.ones(len(data)))
    cfg = _config(**_multi_cfg(tmp_path, data), curriculum_learning={
        "enabled": True, "curriculum_type": "other", "min_difficulty": 1,
        "max_difficulty": 9, "schedule_type": "fixed_linear",
        "metric_values_path": str(tmp_path / "v.npy"),
        "schedule_config": {"total_curriculum_step": 3, "difficulty_step": 1}})
    _refusal(cfg, training_data=data)


def test_refusal_metric_curriculum_without_data(tmp_path):
    np.save(str(tmp_path / "v.npy"), np.ones(8))
    _refusal(_config(curriculum_learning={
        "enabled": True, "curriculum_type": "other", "min_difficulty": 1,
        "max_difficulty": 9, "schedule_type": "fixed_linear",
        "metric_values_path": str(tmp_path / "v.npy"),
        "schedule_config": {"total_curriculum_step": 3, "difficulty_step": 1}}))


def test_config_validators_match_jax():
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

    bad = [{"data_efficiency": {"data_sampling": {"curriculum_learning": {
               "enabled": True, "curriculum_metrics": {"a": {"metric_values_path": "x"}}}}}},
           {"data_efficiency": {"data_sampling": {"enabled": True, "curriculum_learning": {
               "enabled": True}}}},
           {"data_efficiency": {"data_sampling": {"enabled": True, "curriculum_learning": {
               "enabled": True, "curriculum_metrics": {"a": {
                   "metric_values_path": "x", "difficulty_type": "rank"}}}}}},
           {"progressive_layer_drop": {"enabled": True, "theta": 0.0}},
           {"eigenvalue": {"max_iter": 0}}]
    for cfg in bad:
        with pytest.raises(ValueError):
            JaxConfig({"train_batch_size": 1, **cfg})
        with pytest.raises(ValueError):
            DeepSpeedConfig({"train_batch_size": 1, **cfg})
    ok = DeepSpeedConfig({"train_batch_size": 1, "eigenvalue": {"enabled": True},
                          "progressive_layer_drop": {"enabled": True}})
    theirs = JaxConfig({"train_batch_size": 1})
    assert (ok.eigenvalue.max_iter, ok.eigenvalue.tol, ok.eigenvalue.stability) == (
        theirs.eigenvalue.max_iter, theirs.eigenvalue.tol, theirs.eigenvalue.stability)
    assert (ok.progressive_layer_drop.theta, ok.progressive_layer_drop.gamma) == (
        theirs.progressive_layer_drop.theta, theirs.progressive_layer_drop.gamma)
    assert os.path.basename(tdp.__file__) == "__init__.py"
