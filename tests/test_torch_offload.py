"""The port's ZeRO-Offload and ZeRO-Infinity (``ops/adam/cpu_adam.py``,
``ops/csrc/{cpu_adam,aio}.cpp`` built with g++ into the port's own build
directory, ``runtime/swap_tensor``, ``runtime/offload.py``,
``runtime/zero/infinity.py``) against the JAX package and against the
port's own device engine.

- the CPU Adam against JAX's ``DeepSpeedCPUAdam.step_flat`` on the same
  numpy buffers: masters, moments and bf16 views bit-equal, for adam and
  adamw, bias correction on and off;
- ``HostAdamOptimizer`` and ``SwappedAdamOptimizer`` against JAX's over 3
  steps: the returned bf16 views, the state and the checkpoint files
  (``save_offload_state_files``) bit-equal;
- the engine's offload modes (``host_step``, ``streamed``, ``nvme``,
  ZeRO-Infinity) against the device engine from the seed's weights (bf16
  over fp32 masters, ``tiny``): the first loss equal, every fp32 master
  within 1e-6 of the device engine's after step 1, relative to its leaf's
  largest magnitude (the host Adam's ``lr / bc1`` and ``sqrt(v) /
  sqrt(bc2)`` round apart from the chain's ``m / bc1 / sqrt(v / bc2)``);
- a save and resume of the host, NVMe and Infinity state: the steps after
  the resume equal the uninterrupted run's bit for bit, losses and masters;
- every JAX refusal, with its message.

The host ops build with g++; the tests skip only where no C++ compiler
exists (``tests/unit/test_nvme_offload.py:17`` does the same).
"""
import os
import shutil

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as ds
from deepspeed_tpu_torch.models import CausalLM
from deepspeed_tpu_torch.utils.tree import tree_flatten_with_path

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ compiler: the host ops cannot build")

MASTER_RTOL = 1e-6


@pytest.mark.parametrize("adamw", [True, False], ids=["adamw", "adam"])
@pytest.mark.parametrize("bias_correction", [True, False], ids=["bc", "nobc"])
def test_cpu_adam_bit_equal_to_jax(adamw, bias_correction):
    from deepspeed_tpu.ops.adam.cpu_adam import DeepSpeedCPUAdam as JaxAdam
    from deepspeed_tpu_torch.ops.adam import DeepSpeedCPUAdam

    rs = np.random.RandomState(0)
    n = 4099
    p0 = rs.randn(n).astype(np.float32)
    kw = dict(lr=3e-3, betas=(0.9, 0.95), eps=1e-6, weight_decay=0.05,
              adamw_mode=adamw, bias_correction=bias_correction)
    bufs = {}
    for name, cls in (("jax", JaxAdam), ("port", DeepSpeedCPUAdam)):
        opt = cls(**kw)
        p, m, v = p0.copy(), np.zeros(n, np.float32), np.zeros(n, np.float32)
        out = np.empty(n, np.uint16)
        for step in range(1, 4):
            g = np.random.RandomState(step).randn(n).astype(np.float32)
            opt.step_flat(p, g, m, v, step=step, bf16_out=out)
        bufs[name] = (p, m, v, out)
    for a, b in zip(bufs["port"], bufs["jax"]):
        np.testing.assert_array_equal(a, b)
    # torch CPU tensors take the same path (bf16 out as torch.bfloat16)
    opt = DeepSpeedCPUAdam(**kw)
    p, m, v = (torch.from_numpy(p0.copy()), torch.zeros(n), torch.zeros(n))
    out = torch.empty(n, dtype=torch.bfloat16)
    for step in range(1, 4):
        g = torch.from_numpy(np.random.RandomState(step).randn(n).astype(np.float32))
        opt.step_flat(p, g, m, v, step=step, bf16_out=out)
    np.testing.assert_array_equal(p.numpy(), bufs["jax"][0])
    np.testing.assert_array_equal(out.view(torch.int16).numpy().view(np.uint16),
                                  bufs["jax"][3])
    assert opt.num_threads >= 1


def _masters(seed=0):
    rs = np.random.RandomState(seed)
    return {"a": rs.randn(64, 33).astype(np.float32),
            "layers/b": rs.randn(3, 5000).astype(np.float32),
            "c": rs.randn(7).astype(np.float32)}


@pytest.mark.parametrize("kind", ["host", "nvme"])
def test_optimizers_and_state_files_bit_equal_to_jax(kind, tmp_path):
    from deepspeed_tpu.runtime import offload as joff
    from deepspeed_tpu.runtime.swap_tensor import (HostAdamOptimizer as JHost,
                                                   SwappedAdamOptimizer as JSwap)
    from deepspeed_tpu_torch.runtime import offload as poff
    from deepspeed_tpu_torch.runtime.swap_tensor import (HostAdamOptimizer,
                                                         SwappedAdamOptimizer)

    kw = dict(lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01, adamw_mode=True)
    opts = {}
    for name, cls in (("jax", JHost if kind == "host" else JSwap),
                      ("port", HostAdamOptimizer if kind == "host" else SwappedAdamOptimizer)):
        extra = {} if kind == "host" else {"swap_dir": str(tmp_path / f"{name}_swap"),
                                           "pipeline": True}
        opts[name] = cls(_masters(), **extra, **kw)
    for step in range(3):
        rs = np.random.RandomState(10 + step)
        grads = {k: rs.randn(*v.shape).astype(np.float32) for k, v in _masters().items()}
        outs = {name: opt.step(grads, lr=1e-3 * (step + 1)) for name, opt in opts.items()}
        for k in grads:
            np.testing.assert_array_equal(outs["port"][k], outs["jax"][k])
    for k in _masters():
        for a, b in zip(opts["port"].read_state(k), opts["jax"].read_state(k)):
            np.testing.assert_array_equal(a, b)
    names = list(_masters())
    poff.save_offload_state_files(str(tmp_path / "port"), names, opts["port"].read_state,
                                  opts["port"].step_count)
    joff.save_offload_state_files(str(tmp_path / "jax"), names, opts["jax"].read_state,
                                  opts["jax"].step_count)
    for f in sorted(os.listdir(tmp_path / "jax")):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    # and the port restores JAX's files
    fresh = (HostAdamOptimizer(_masters(1), **kw) if kind == "host" else
             SwappedAdamOptimizer(_masters(1), str(tmp_path / "fresh"), **kw))
    fresh.step_count = poff.load_offload_state_files(
        str(tmp_path / "jax"), names, fresh.write_state,
        expected_shapes={k: v.shape for k, v in _masters().items()})
    assert fresh.step_count == 3
    for k in names:
        for a, b in zip(fresh.read_state(k), opts["jax"].read_state(k)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="shape mismatch"):
        poff.load_offload_state_files(str(tmp_path / "jax"), names, fresh.write_state,
                                      expected_shapes={**{k: v.shape for k, v in
                                                          _masters().items()}, "c": (8,)})


def test_aio_round_trip_and_bench(tmp_path):
    from deepspeed_tpu_torch.ops import aio_bench
    from deepspeed_tpu_torch.runtime.swap_tensor import TensorSwapper, aligned_empty

    sw = TensorSwapper(str(tmp_path / "sw"), aio_threads=4)
    x = aligned_empty((3 << 20,), np.float32)   # 12 MiB: several threads
    x[:] = np.arange(x.size, dtype=np.float32)
    sw.write("x", x)
    h, y = sw.submit_read("x")
    sw.wait(h)
    np.testing.assert_array_equal(x, y)
    assert y.ctypes.data % 4096 == 0
    assert sw.bytes_read == sw.bytes_written == x.nbytes
    sw.close()
    res = aio_bench.main(["--path", str(tmp_path / "b.bin"), "--size-mb", "2",
                          "--threads", "1", "2"])
    assert {r["op"] for r in res} == {"read", "write"} and all(r["gbps"] > 0 for r in res)


def test_numa_parse_and_binding_is_safe():
    from deepspeed_tpu.utils import numa as jnuma
    from deepspeed_tpu_torch.utils import numa

    for text in ("0-3,8-11", "5", "", "0,2-3"):
        assert numa._parse_cpu_list(text) == jnuma._parse_cpu_list(text)
    before = numa.current_affinity()
    os.environ["DS_TPU_NUMA_NODE"] = "off"
    try:
        assert numa.bind_for_offload() == []
    finally:
        del os.environ["DS_TPU_NUMA_NODE"]
    assert numa.current_affinity() == before


def _cfg(tmp_path, mode, stage=1, **extra):
    zo = {"stage": stage}
    if mode == "host_step":
        zo["offload_optimizer"] = {"device": "cpu"}
    elif mode == "streamed":
        zo["offload_optimizer"] = {"device": "cpu", "host_step": False}
    elif mode == "nvme":
        zo["offload_optimizer"] = {"device": "nvme", "nvme_path": str(tmp_path / "nvme")}
    elif mode == "infinity":
        zo = {"stage": 3, "offload_param": {"device": "nvme",
                                            "nvme_path": str(tmp_path / "inf")}}
    return {"train_batch_size": 4, "gradient_accumulation_steps": 2,
            "bf16": {"enabled": True}, "seed": 5, "gradient_clipping": 1.0,
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3, "weight_decay": 0.01}},
            "zero_optimization": zo, "steps_per_print": 10 ** 9, **extra}


def _batches(n, seed=3):
    rs = np.random.RandomState(seed)
    return [{"input_ids": rs.randint(0, 256, (4, 16))} for _ in range(n)]


def _host_masters(engine) -> dict:
    off = engine._offload or engine._param_offload
    if off is None:
        return {p: x.numpy().copy() for p, x in
                tree_flatten_with_path(engine.state.master_params)}
    m = off.read_masters()
    if engine._param_offload is not None:   # per-layer files -> stacked leaves
        out = {}
        for k, v in m.items():
            if k.startswith("layers."):
                _, i, leaf = k.split(".", 2)
                out.setdefault(f"layers/{leaf}", {})[int(i)] = v
            else:
                out[k] = v
        return {k: (np.stack([v[i] for i in sorted(v)]) if isinstance(v, dict) else
                    np.array(v)) for k, v in out.items()}
    return {k: np.array(v) for k, v in m.items()}


@pytest.fixture(scope="module")
def device_run(tmp_path_factory):
    eng, *_ = ds.initialize(model=CausalLM("tiny"), device="cpu",
                            config=_cfg(tmp_path_factory.mktemp("d"), "none"))
    loss = float(eng.train_batch(batch=_batches(1)[0]))
    return loss, _host_masters(eng), eng.get_global_grad_norm()


@pytest.mark.parametrize("mode", ["host_step", "streamed", "nvme", "infinity"])
def test_offload_modes_match_the_device_engine(mode, tmp_path, device_run):
    loss0, masters0, norm0 = device_run
    eng, *_ = ds.initialize(model=CausalLM("tiny"), device="cpu",
                            config=_cfg(tmp_path, mode))
    assert (eng._offload is not None) == (mode in ("host_step", "nvme"))
    assert (eng._param_offload is not None) == (mode == "infinity")
    loss = float(eng.train_batch(batch=_batches(1)[0]))
    assert loss == loss0
    np.testing.assert_allclose(eng.get_global_grad_norm(), norm0, rtol=1e-5)
    got = _host_masters(eng)
    assert set(got) == set(masters0)
    for k, ref in masters0.items():
        scale = np.abs(ref).max()
        assert np.abs(got[k] - ref).max() <= MASTER_RTOL * scale, k
    if mode in ("host_step", "nvme", "infinity"):   # the card keeps no fp32 masters
        assert eng.state is None or eng.state.master_params is None


@pytest.mark.parametrize("mode", ["host_step", "nvme", "infinity"])
def test_offload_resume_is_bit_exact(mode, tmp_path):
    batches = _batches(4)
    ref, *_ = ds.initialize(model=CausalLM("tiny"), device="cpu",
                            config=_cfg(tmp_path / "a", mode))
    for b in batches[:2]:
        ref.train_batch(batch=b)
    ref.save_checkpoint(str(tmp_path / "ckpt"), tag="t")
    want = [float(ref.train_batch(batch=b)) for b in batches[2:]]
    want_masters = _host_masters(ref)
    files = os.listdir(tmp_path / "ckpt" / "t" / "offload_optimizer")
    assert "meta.json" in files and any(f.endswith(".master.npy") for f in files)
    new, *_ = ds.initialize(model=CausalLM("tiny"), device="cpu",
                            config=_cfg(tmp_path / "b", mode))
    new.load_checkpoint(str(tmp_path / "ckpt"), tag="t")
    assert new.global_steps == 2
    got = [float(new.train_batch(batch=b)) for b in batches[2:]]
    assert got == want
    for k, v in _host_masters(new).items():
        np.testing.assert_array_equal(v, want_masters[k])
    with pytest.raises(NotImplementedError, match="partial checkpoint loads"):
        new.load_checkpoint(str(tmp_path / "ckpt"), tag="t", load_module_only=True)


def _jax_error(cfg):
    """The JAX engine's exception for ``cfg`` (one device, ``tiny``)."""
    import jax

    import deepspeed_tpu
    from deepspeed_tpu.models import CausalLM as JaxCausalLM
    from deepspeed_tpu.models import transformer as jtf
    from deepspeed_tpu.parallel import mesh as jmesh

    jmesh.reset_mesh()
    try:
        mesh = jmesh.initialize_mesh(jmesh.MeshLayout(dp=1), devices=jax.devices()[:1])
        model = JaxCausalLM(jtf.get_config("tiny"))
        if cfg.pop("_frozen", False):
            model.frozen_spec = lambda: jax.tree_util.tree_map(
                lambda _: True, jtf.init_params(jtf.get_config("tiny"), jax.random.PRNGKey(0)))
        deepspeed_tpu.initialize(model=model, config=cfg, mesh=mesh)
    except Exception as e:   # noqa: BLE001
        return e
    finally:
        jmesh.reset_mesh()
    return None


REFUSALS = {
    "nvme_requires_path": ({"stage": 1, "offload_optimizer": {"device": "nvme"}}, {},
                           "offload_optimizer.device=nvme requires nvme_path"),
    "param_nvme_requires_path": ({"stage": 3, "offload_param": {"device": "nvme"}}, {},
                                 "offload_param.device=nvme requires nvme_path"),
    "param_cpu": ({"stage": 3, "offload_param": {"device": "cpu"}}, {},
                  "offload_param.device=cpu"),
    "param_stage": ({"stage": 2, "offload_param": {"device": "nvme", "nvme_path": "x"}}, {},
                    "offload_param requires stage=3"),
    "fp32_host_step": ({"stage": 1, "offload_optimizer": {"device": "cpu", "host_step": True}},
                       {"bf16": {"enabled": False}}, "optimizer offload requires bf16/fp16"),
    "param_and_optimizer": ({"stage": 3, "offload_param": {"device": "nvme", "nvme_path": "x"},
                             "offload_optimizer": {"device": "cpu"}}, {},
                            "offload_param already places the optimizer state"),
    "param_onebit": ({"stage": 0, "offload_param": {"device": "nvme", "nvme_path": "x"}},
                     {"optimizer": {"type": "OneBitAdam", "params": {}}},
                     "offload_param requires stage=3"),
    "host_step_lamb_like": ({"stage": 1, "offload_optimizer": {"device": "cpu",
                                                               "host_step": True}},
                            {"optimizer": {"type": "OneBitAdam", "params": {}}},
                            "not supported on the host path"),
    "frozen_host_step": ({"stage": 1, "offload_optimizer": {"device": "cpu"}},
                         {"_frozen": True}, "model.frozen_spec does not compose with optimizer"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_offload_refusals_match_jax(name, tmp_path):
    zero, extra, msg = REFUSALS[name]
    cfg = {"train_batch_size": 2, "bf16": {"enabled": True},
           "zero_optimization": zero, **extra}
    theirs = _jax_error(dict(cfg))
    assert theirs is not None and msg in str(theirs), theirs
    model = CausalLM("tiny", frozen_keywords=("embed",)) if extra.get("_frozen") \
        else CausalLM("tiny")
    cfg.pop("_frozen", None)
    with pytest.raises(type(theirs)) as ours:
        ds.initialize(model=model, config=cfg, device="cpu")
    assert msg in str(ours.value)


# ---------------------------------------------------------------------------
# ZeRO-Infinity above one data rank: each rank stores its own shards
# ---------------------------------------------------------------------------

def _infinity_cfg(nvme, train_batch=4, gas=2):
    return {"train_batch_size": train_batch, "gradient_accumulation_steps": gas,
            "bf16": {"enabled": True}, "seed": 5, "gradient_clipping": 1.0,
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3, "weight_decay": 0.01}},
            "zero_optimization": {"stage": 3, "offload_param": {
                "device": "nvme", "nvme_path": str(nvme)}},
            "steps_per_print": 10 ** 9}


@pytest.mark.parametrize("world", [2, 3])
def test_infinity_at_two_ranks_stores_its_own_shards(world, tmp_path):
    """gloo ranks: each rank's files hold its 1/world of every leaf the
    planner shards (at 2 ranks every leaf of ``tiny``; at 3 none: no dim
    divides, so every rank holds them whole and the norm weighs each 1/3),
    its host gradients that share of the one-rank engine's bytes; the first
    step's masters are the one-rank engine's within MASTER_RTOL, the 4
    steps' losses and norms within 1e-4 (the mean over the ranks rounds
    apart from the window's, and Adam carries it: 1.1e-5 at step 4 at 3
    ranks); the resume of each rank's files is bit-exact."""
    from ._torch_ranks import run_ranks

    rows = 2 * world
    rs = np.random.RandomState(3)
    batches = [{"input_ids": rs.randint(0, 256, (rows, 16))} for _ in range(4)]
    # one row a micro-batch in both runs: each row's bf16 gradient is the
    # same computation, only their fp32 sums group differently
    one, *_ = ds.initialize(model=CausalLM("tiny"), device="cpu",
                            config=_infinity_cfg(tmp_path / "one", rows, gas=rows))
    want = [float(one.train_batch(batch=batches[0]))]
    full = {k: np.array(v) for k, v in one._param_offload.read_masters().items()}
    want_norms = [one.get_global_grad_norm()]
    for b in batches[1:]:
        want.append(float(one.train_batch(batch=b)))
        want_norms.append(one.get_global_grad_norm())
    one_grad_bytes = one._param_offload.stats["host_grad_bytes"]
    one_nvme = sum(os.path.getsize(os.path.join(d, f))
                   for d, _, fs in os.walk(tmp_path / "one") for f in fs)
    res = run_ranks(world, "infinity", tmp_path, timeout=120,
                    config=_infinity_cfg(tmp_path / "inf", rows, gas=2), batches=batches,
                    ckpt_dir=str(tmp_path / "ckpt"), save_at=2)
    dims = res[0]["shard_dims"]

    def dim(name):
        return dims[name.split(".", 2)[2] if name.startswith("layers.") else name]

    sharded = sum(full[n].size for n in full if dim(n) is not None)
    assert sharded == (sum(x.size for x in full.values()) if world == 2 else 0)
    for r, rec in enumerate(res):
        for name, shape in rec["file_shapes"].items():
            whole, d = full[name].shape, dim(name)
            expect = whole if d is None else tuple(
                n // world if i == d else n for i, n in enumerate(whole))
            assert shape == expect, (name, shape, whole)
            ref = full[name] if d is None else np.split(full[name], world, axis=d)[r]
            scale = max(np.abs(full[name]).max(), 1e-30)
            assert np.abs(rec["masters1"][name] - ref).max() <= MASTER_RTOL * scale, name
        assert rec["host_grad_bytes"] == one_grad_bytes - 4 * sharded * (world - 1) // world
        if sharded:
            assert rec["nvme_bytes"] < 0.6 * one_nvme
        np.testing.assert_allclose(rec["losses"], want, rtol=1e-4)
        np.testing.assert_allclose(rec["norms"], want_norms, rtol=1e-4)
        assert rec["resumed"] == rec["losses"][2:]
        for name, v in rec["resumed_masters"].items():
            np.testing.assert_array_equal(v, rec["masters"][name])


def test_mesh_config_block_trains_as_the_mesh_argument(tmp_path):
    """``mesh: {pp: 2}`` and ``mesh: {ep: 2}`` in the config build the mesh
    ``mesh=MeshLayout(...)`` names: the same trajectory, bit for bit (a
    pipelined ``tiny`` over the 'pipe' axis, ``tiny-moe`` over 'expert')."""
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

    from ._torch_ranks import make_batches, run_ranks

    for block in ({"pp": 2}, {"ep": 2}):
        DeepSpeedConfig({"train_micro_batch_size_per_gpu": 1, "mesh": block})
    base = {"train_batch_size": 4, "gradient_accumulation_steps": 1,
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}, "seed": 3}
    pp_kw = {"pipeline_stages": 2, "pipeline_microbatches": 2}
    cases = [
        {"config": {**base, "mesh": {"pp": 2}}, "model_kw": pp_kw, "no_params": True,
         "dtype": "float32"},
        {"config": base, "mesh": {"pp": 2}, "model_kw": pp_kw, "no_params": True,
         "dtype": "float32"},
        {"config": {**base, "mesh": {"ep": 2}}, "model": "tiny-moe", "no_params": True,
         "dtype": "float32"},
        {"config": base, "mesh": {"ep": 2}, "model": "tiny-moe", "no_params": True,
         "dtype": "float32"},
    ]
    res = run_ranks(2, "train", tmp_path, timeout=120, cases=cases, params_np=None,
                    batches=make_batches(3, 4, 7))
    for rec in res:
        for a, b in ((0, 1), (2, 3)):
            assert rec[a]["losses"] == rec[b]["losses"]
            assert np.isfinite(rec[a]["losses"]).all()
            for k, v in rec[a]["masters"].items():
                np.testing.assert_array_equal(v, rec[b]["masters"][k])
