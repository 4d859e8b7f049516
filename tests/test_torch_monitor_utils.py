"""The port's monitors (``deepspeed_tpu_torch/monitor``), the engine's
monitor events and the utilities ``utils/debug.py``,
``utils/init_on_device.py`` and ``utils/compile_counter.py`` against the
JAX package's.

Exact comparisons throughout: the CSV files' bytes equal JAX's for the
same events; the TensorBoard event file reads back the events written
(values as the float32 TensorBoard stores); ``InMemoryMonitor``'s ring
answers as JAX's; ``checksum_tree`` gives JAX's hex digests for the same
numpy tree (float32, int32 and bfloat16 leaves); the engine's events equal
the losses ``train_batch`` returned.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
from deepspeed_tpu.models import CausalLM as JaxCausalLM
from deepspeed_tpu.monitor import monitor as JM
from deepspeed_tpu.runtime import config as JC
from deepspeed_tpu.utils import debug as JD
from deepspeed_tpu.utils import init_on_device as JO

import deepspeed_tpu_torch as ds
from deepspeed_tpu_torch.models import CausalLM
from deepspeed_tpu_torch.monitor import monitor as TM
from deepspeed_tpu_torch.runtime import config as TC
from deepspeed_tpu_torch.utils import compile_counter as cc
from deepspeed_tpu_torch.utils import debug as TD
from deepspeed_tpu_torch.utils.init_on_device import OnDevice, current_on_device

from ._torch_ranks import run_ranks

torch.set_num_threads(1)

EVENTS = [("Train/Samples/train_loss", 5.5625, 1), ("Train/Samples/lr", 1e-3, 1),
          ("Train/Samples/train_loss", 0.1 + 0.2, 2), ("serve/x", 7, 3),
          ("Train/Samples/lr", 3.0e-7, 2)]


def _csv_files(root) -> dict:
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(dirpath, f), "rb") as fh:
                out[os.path.relpath(os.path.join(dirpath, f), root)] = fh.read()
    return out


def test_csv_bytes_equal_jax(tmp_path):
    jm = JM.csvMonitor(JC.CSVConfig(enabled=True, output_path=str(tmp_path / "jax"),
                                    job_name="job"))
    tm = TM.csvMonitor(TC.CSVConfig(enabled=True, output_path=str(tmp_path / "port"),
                                    job_name="job"))
    for mon in (jm, tm):
        mon.write_events(EVENTS[:3])
        mon.write_events(EVENTS[3:])
        mon.write_report("hang/dump", "stack\nlines")
    theirs, ours = _csv_files(tmp_path / "jax"), _csv_files(tmp_path / "port")
    assert ours == theirs and len(ours) == 4
    off = TM.csvMonitor(TC.CSVConfig(enabled=False, output_path=str(tmp_path / "off")))
    off.write_events(EVENTS)
    assert not (tmp_path / "off").exists()


def _read_tensorboard(log_dir) -> list:
    from tensorboard.backend.event_processing.event_file_loader import EventFileLoader

    out = []
    for name in sorted(os.listdir(log_dir)):
        for event in EventFileLoader(os.path.join(log_dir, name)).Load():
            for v in event.summary.value:
                value = (v.simple_value if v.HasField("simple_value")
                         else float(np.frombuffer(v.tensor.tensor_content, np.float32)[0])
                         if v.tensor.tensor_content else v.tensor.float_val[0])
                out.append((v.tag, value, event.step))
    return out


def test_tensorboard_events_read_back(tmp_path):
    mon = TM.TensorBoardMonitor(TC.TensorBoardConfig(
        enabled=True, output_path=str(tmp_path), job_name="job"))
    mon.write_events(EVENTS)
    mon.summary_writer.close()
    got = _read_tensorboard(tmp_path / "job")
    assert got == [(n, float(np.float32(v)), s) for n, v, s in EVENTS]
    assert TM.TensorBoardMonitor(TC.TensorBoardConfig()).summary_writer is None


def test_wandb_absent_warns_and_disables(monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)   # import fails, no network
    warned = []
    monkeypatch.setattr(TM.logger, "warning", lambda msg, *a: warned.append(msg))
    mon = TM.WandbMonitor(TC.WandbConfig(enabled=True))
    assert mon.enabled is False
    mon.write_events(EVENTS)
    assert len(warned) == 1 and "wandb unavailable" in warned[0]


def test_in_memory_ring_matches_jax():
    jm, tm = JM.InMemoryMonitor(max_events=3, max_reports=1), \
        TM.InMemoryMonitor(max_events=3, max_reports=1)
    for mon in (jm, tm):
        mon.write_events(EVENTS)
        mon.write_report("a", "x")
        mon.write_report("b", "y")
    for attr in ("dropped_events", "dropped_reports"):
        assert getattr(tm, attr) == getattr(jm, attr)
    assert tm.events_snapshot() == jm.events_snapshot() and len(tm.events) == 3
    assert list(tm.reports) == list(jm.reports) == [("b", "y")]
    for name in ("Train/Samples/train_loss", "Train/Samples/lr", "serve/x", "none"):
        assert tm.series(name) == jm.series(name)
        assert tm.latest(name) == jm.latest(name)
    assert tm.latest_map() == jm.latest_map()
    for mod in (TM, JM):
        with pytest.raises(ValueError, match="must be >= 1"):
            mod.InMemoryMonitor(max_events=0)


def test_monitor_master_fans_out(tmp_path):
    cfg = TC.config_from_dict(TC.MonitorConfig, {
        "csv_monitor": {"enabled": True, "output_path": str(tmp_path), "job_name": "j"}})
    assert cfg.enabled
    master = TM.MonitorMaster(cfg)
    master.write_events(EVENTS[:1])
    master.write_report("r", "text")
    assert sorted(os.listdir(tmp_path / "j")) == ["Train_Samples_train_loss.csv", "r.txt"]
    assert not TC.MonitorConfig().enabled


@pytest.mark.parametrize("extra", ["plain", "fp16", "pld"])
def test_engine_events_are_the_losses(tmp_path, extra):
    """``Train/Samples/train_loss`` and ``lr`` each step (``loss_scale``
    under fp16, ``pld_theta`` under progressive layer drop), in the CSV
    monitor, equal to what ``train_batch`` returned; from step 2, once an
    inter-step wall exists, the live ``train/tflops_est`` and
    ``train/mfu_est`` gauges (0 without ``DS_TPU_PEAK_TFLOPS``), as the JAX
    engine writes them."""
    config = {"train_batch_size": 2, "steps_per_print": 10 ** 9,
              "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
              "csv_monitor": {"enabled": True, "output_path": str(tmp_path), "job_name": "j"}}
    if extra == "fp16":
        config["fp16"] = {"enabled": True, "initial_scale_power": 8}
    if extra == "pld":
        config["progressive_layer_drop"] = {"enabled": True, "theta": 0.5, "gamma": 0.1}
    eng, *_ = ds.initialize(model=CausalLM("tiny", dtype=torch.float32), config=config,
                            device="cpu")
    batch = {"input_ids": np.random.default_rng(0).integers(0, 256, (2, 16))}
    losses = [float(eng.train_batch(batch=batch)) for _ in range(3)]
    rows = (tmp_path / "j" / "Train_Samples_train_loss.csv").read_text().splitlines()
    assert rows[0] == "step,value"
    assert [(int(r.split(",")[0]), float(r.split(",")[1])) for r in rows[1:]] == \
        list(zip((1, 2, 3), losses))
    names = sorted(os.listdir(tmp_path / "j"))
    want = {"plain": [], "fp16": ["Train_Samples_loss_scale.csv"],
            "pld": ["Train_Samples_pld_theta.csv"]}[extra]
    assert names == sorted(["Train_Samples_lr.csv", "Train_Samples_train_loss.csv",
                            "train_mfu_est.csv", "train_tflops_est.csv"] + want)
    for name in ("train_tflops_est.csv", "train_mfu_est.csv"):
        rows = (tmp_path / "j" / name).read_text().splitlines()[1:]
        assert [int(r.split(",")[0]) for r in rows] == [2, 3]
        assert all(float(r.split(",")[1]) >= 0 for r in rows)
    lr = (tmp_path / "j" / "Train_Samples_lr.csv").read_text().splitlines()[1:]
    assert [float(r.split(",")[1]) for r in lr] == [1e-3] * 3


# ------------------------------------------------------------------ debug --

def _np_tree():
    rng = np.random.default_rng(0)
    f32 = rng.normal(size=(3, 5)).astype(np.float32)
    bf = jnp.asarray(rng.normal(size=(4,)), jnp.bfloat16)
    return {"a": f32, "b": {"c": np.arange(6, dtype=np.int32).reshape(2, 3),
                            "d": np.asarray(bf)}, "s": np.full((), 2.5, np.float32)}


def test_checksum_tree_hex_equals_jax():
    tree = _np_tree()
    ref = JD.checksum_tree(jax.tree_util.tree_map(jnp.asarray, tree))
    port = {"a": torch.from_numpy(tree["a"]),
            "b": {"c": torch.from_numpy(tree["b"]["c"]),
                  "d": torch.from_numpy(tree["b"]["d"].view(np.int16)).view(torch.bfloat16)},
            "s": torch.from_numpy(tree["s"])}
    ours = TD.checksum_tree(port)
    assert ours == ref and set(ours) == {"a", "b/c", "b/d", "s"}
    assert TD.checksum_tree(tree) == ref          # numpy leaves as they are
    port["a"][0, 0] += 1
    assert TD.checksum_tree(port)["a"] != ref["a"]
    assert TD.checksum_tree({"x": torch.arange(4, dtype=torch.int32)})["x"] != \
        TD.checksum_tree({"x": torch.arange(4, dtype=torch.float32)})["x"]
    assert TD.path_str(("layers", "wq")) == "layers/wq" == TD.path_str("layers/wq")


@pytest.mark.parametrize("bad_rank", [-1, 1])
def test_replicas_consistent_over_two_ranks(bad_rank, tmp_path):
    tree = {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
            "b": np.ones(4, np.float32), "n": np.arange(3, dtype=np.int64)}
    out = run_ranks(2, "replicas", tmp_path, tree_np=tree, bad_rank=bad_rank, bad_leaf="w")
    if bad_rank < 0:
        assert out[0] == out[1] and out[0][0] == "ok"
        assert out[0][1] == TD.checksum_tree(tree)
    else:
        for status, msg in out:
            assert status == "raised"
            assert "replica divergence in probe: 1 leaves" in msg and "'w'" in msg
            assert "(0, 1)" in msg
    local = TD.assert_replicas_consistent({"w": torch.ones(2)})   # no process group
    assert local == TD.checksum_tree({"w": torch.ones(2)})


def test_assert_deterministic():
    x = torch.randn(8, 8, generator=torch.Generator().manual_seed(0))
    out = TD.assert_deterministic(lambda: torch.sin(x) @ torch.cos(x.T), what="matmul")
    assert out.shape == (8, 8)
    state = {"n": 0}

    def impure():
        state["n"] += 1
        return torch.tensor(float(state["n"]))

    with pytest.raises(RuntimeError, match="impure is nondeterministic"):
        TD.assert_deterministic(impure, what="impure")


def test_probe_device_count():
    n, err = TD.probe_device_count(timeout_s=30)
    assert err is None and n == torch.cuda.device_count()


# --------------------------------------------------------------- OnDevice --

def test_on_device_meta_builds_shapes_only():
    """llama2-7b under ``OnDevice(device="meta")``: meta leaves in the
    context's dtype, shaped as the real tree (``tiny``'s real tree on the
    CPU holds the same shapes as its meta one)."""
    model = CausalLM("llama2-7b")
    with OnDevice(dtype=torch.bfloat16, device="meta"):
        shapes = model.init_fn(torch.Generator())
    leaves = [x for x in jax.tree_util.tree_leaves(shapes)]
    assert leaves and all(x.is_meta and x.dtype == torch.bfloat16 for x in leaves)
    assert sum(x.numel() for x in leaves) == model.config.param_count
    tiny = CausalLM("tiny")
    with OnDevice(device="meta"):
        meta = tiny.init_fn(torch.Generator())
    real = tiny.init_fn(torch.Generator(), device="cpu")
    assert jax.tree_util.tree_map(lambda x: (tuple(x.shape), x.dtype), meta) == \
        jax.tree_util.tree_map(lambda x: (tuple(x.shape), x.dtype), real)
    # the JAX package's meta tree has the same shapes
    with deepspeed_tpu.OnDevice(device="meta"):
        jshapes = JaxCausalLM("tiny").init_fn(jax.random.PRNGKey(0))
    assert jax.tree_util.tree_map(lambda x: tuple(x.shape), jshapes) == \
        jax.tree_util.tree_map(lambda x: tuple(x.shape), meta)


def test_on_device_cpu_materializes_and_nests():
    model = CausalLM("tiny")
    with OnDevice(dtype=torch.float64, device="cpu"):
        params = model.init_fn(torch.Generator())
    leaf = jax.tree_util.tree_leaves(params)[0]
    assert leaf.device.type == "cpu" and leaf.dtype == torch.float64 and not leaf.is_meta
    assert current_on_device() is None
    with OnDevice(device="meta") as outer:
        assert current_on_device() is outer
        with OnDevice(device="cpu", enabled=False):
            assert current_on_device() is outer
        with OnDevice(device="cpu") as inner:
            assert current_on_device() is inner
        assert current_on_device() is outer
    assert current_on_device() is None


def test_on_device_covers_the_pipeline_module():
    from deepspeed_tpu_torch.runtime.pipe.module import LayerSpec, PipelineModule

    pm = PipelineModule([LayerSpec(torch.nn.Linear, 8, 8)], num_stages=1)
    with OnDevice(device="meta"):
        shapes = pm.init_fn(torch.Generator())
    leaves = jax.tree_util.tree_leaves(shapes)
    assert leaves and all(x.is_meta for x in leaves)


def test_initialize_refuses_an_active_on_device():
    """Both packages refuse, naming the context and telling the caller to
    close it first (the port's words name its own entry point)."""
    match = "OnDevice context is active .* Close the OnDevice context before"
    with OnDevice(device="meta"):
        with pytest.raises(RuntimeError, match=match):
            ds.initialize(model=CausalLM("tiny", dtype=torch.float32),
                          config={"train_batch_size": 1}, device="cpu")
    with JO.OnDevice(device="meta"):
        with pytest.raises(RuntimeError, match=match):
            deepspeed_tpu.initialize(model=JaxCausalLM("tiny"),
                                     config={"train_batch_size": 8})
    assert ds.OnDevice is OnDevice


# ---------------------------------------------------------- compile counter --

def test_compile_counter_counts_captures_across_threads():
    """Every recorded capture counts once, from any thread: the counter
    takes JAX's signature (no arguments) and each caller diffs it."""
    import threading

    count = cc.compile_counter()
    before = count()
    threads = [threading.Thread(target=lambda: [cc.record_compile() for _ in range(250)])
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert count() - before == 1000
    assert cc.compile_counter()() == count()


def test_compile_counter_around_a_serving_run():
    """A serving run on the CPU decodes eagerly: no capture, as its
    program inventory says; the counter moves with the captures."""
    count = cc.compile_counter()
    model = CausalLM("tiny", dtype=torch.float32)
    params = model.init_fn(torch.Generator().manual_seed(0), device="cpu")
    eng = ds.init_inference(model, config={"dtype": "float32"}, params=params, device="cpu")
    before = count()
    sv = eng.serving(b_slots=2, page_size=8, max_model_len=32)
    from deepspeed_tpu_torch.inference import Request

    sv.run([Request(0, input_ids=np.arange(1, 6), max_new_tokens=4)])
    assert count() - before == sv.program_inventory()["captures"] == 0
