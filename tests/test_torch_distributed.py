"""The port's distributed layer: the comm facade, the mesh, the ZeRO
planner, sharded checkpoints and the ZeRO APIs.

- **Comm**: every facade op over every axis of a 4-rank layout (data x
  data_outer, 2 x 2) and of tuples of axes, on gloo ranks
  (``tests/_torch_ranks.py``, jax-free), against numpy, exactly; the comms
  logger's call counts and bytes per op kind; single-process
  ``init_distributed`` (no group, identity collectives).
- **Mesh**: ``MeshLayout``, ``ProcessTopology`` and the MiCS factorization
  (values and error messages) equal the JAX package's.
- **Planner**: for every leaf of ``tiny`` and of
  ``tests/unit/test_zero_unbalanced.py``'s shapes, at stages 0-3, ZeRO
  worlds 2/4/8, with and without a persistence threshold (and with tensor-
  parallel specs over a model axis of 1 and of 2), the mesh axes each
  tensor dim carries equal the JAX ``PartitionSpec``'s.  No process group.
- **Checkpoints**: saved at 2 ranks, stage 3, bf16 over fp32 masters, with
  an async commit; resumed at 2 ranks bit-exact (losses and masters,
  ``array_equal``) against the run that never stopped; loaded at 4 ranks
  and by the one-device engine with identical masters; ``zero_to_fp32``
  of the sharded checkpoint equals the gathered masters.
- **APIs**: ``GatheredParameters`` (host and device), ``zero.Init``;
  ``tiled_linear`` against the JAX package's at fp32 tolerance (rtol/atol
  1e-5: summation order), and on ZeRO shards at 2 ranks against the plain
  product, value and gradient (atol 1e-4 over values of order 10).
"""
import json
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu_torch as ds
from deepspeed_tpu.parallel import mesh as jmesh
from deepspeed_tpu.runtime.zero import planner as jplanner
from deepspeed_tpu.runtime.zero import tiling as jtiling
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu_torch import comm, zero
from deepspeed_tpu_torch.checkpoint import get_fp32_state_dict_from_zero_checkpoint
from deepspeed_tpu_torch.models import CausalLM
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.parallel import mesh as pmesh
from deepspeed_tpu_torch.runtime.zero import planner as pplanner
from deepspeed_tpu_torch.runtime.zero.tiling import TiledLinear, tiled_linear
from deepspeed_tpu_torch.utils.tree import tree_flatten_with_path

from ._torch_ranks import make_batches, run_ranks

# ---------------------------------------------------------------------------
# Comm
# ---------------------------------------------------------------------------

AXES = ["data", "data_outer", ("data_outer", "data"), pmesh.BATCH_AXES, "model"]


@pytest.fixture(scope="module")
def comm_run(tmp_path_factory):
    return run_ranks(4, "comm", tmp_path_factory.mktemp("comm"),
                     layout={"dp": 2, "dp_outer": 2}, axes_list=AXES)


def test_facade_ops_match_numpy(comm_run):
    for rank, got in enumerate(comm_run):
        names = [name for name, _, _ in got["checks"]]
        assert len(names) == len(AXES) * 14
        for name, value, want in got["checks"]:
            np.testing.assert_array_equal(value, want, err_msg=f"rank {rank}: {name}")


def test_comms_logger_counts_and_bytes(comm_run):
    for got in comm_run:
        assert got["totals"] == got["expect"]


def test_comm_benchmark_over_four_ranks(comm_run):
    """Every op of the benchmark runs over the world and reports its size
    (4 KiB) and bandwidths as the ring factors say; the logger's table
    re-times what it logged."""
    for got in comm_run:
        ops = [r["op"] for r in got["bench"]]
        assert ops == ["all_reduce", "all_gather", "reduce_scatter", "all_to_all",
                       "broadcast", "ppermute"]
        for r in got["bench"]:
            assert r["size_bytes"] == 4096 and r["n_devices"] == 4
            assert r["latency_us"] > 0
            factor = {"all_reduce": 1.5, "ppermute": 1.0}.get(r["op"], 0.75)
            np.testing.assert_allclose(r["busbw_gbps"], r["algbw_gbps"] * factor)
        assert "all_gather" in got["table"] and "busbw GB/s" in got["table"]


def test_init_distributed_single_process(monkeypatch):
    """No rank, world size or rendezvous: single-process mode, no group;
    the collectives are identities over size-1 axes."""
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(comm.comm, "_initialized", False)
    comm.init_distributed(verbose=False)
    assert comm.is_initialized() and not torch.distributed.is_initialized()
    assert (comm.get_rank(), comm.get_world_size(), comm.get_local_rank()) == (0, 1, 0)
    x = torch.arange(6.0).reshape(2, 3)
    for out in (comm.all_reduce(x), comm.all_gather(x, "data", 1),
                comm.reduce_scatter(x, "data"), comm.all_to_all(x, "data")):
        assert torch.equal(out, x)
    assert comm.axis_index(pmesh.BATCH_AXES) == 0 and comm.get_axis_size("data") == 1
    assert comm.broadcast_object({"a": 1}) == {"a": 1}
    with pytest.raises(ValueError, match="no rendezvous"):
        monkeypatch.setattr(comm.comm, "_initialized", False)
        comm.init_distributed(rank=0, world_size=2, verbose=False)
    with pytest.raises(ValueError, match="nccl or gloo"):
        comm.init_distributed(dist_backend="xla", verbose=False)


# ---------------------------------------------------------------------------
# Mesh
# ---------------------------------------------------------------------------

def _both(fn_port, fn_jax):
    """Each side's value, or its error message."""
    out = []
    for fn in (fn_port, fn_jax):
        try:
            out.append(fn())
        except (ValueError, AssertionError) as e:
            out.append(("error", str(e)))
    return out


@pytest.mark.parametrize("world,kw", [
    (8, {}), (8, {"tp": 2}), (8, {"dp_outer": 2}), (8, {"pp": 2, "ep": 2}),
    (6, {"tp": 4}), (8, {"dp": 2}), (8, {"dp": 2, "dp_outer": 2, "tp": 2}),
    (4, {"tp": 4}), (4, {"tp": 2, "dp": 2}), (8, {"tp": 8}), (8, {"tp": 2, "dp": 3}),
])
def test_mesh_layout_matches_jax(world, kw):
    ours, theirs = _both(lambda: pmesh.MeshLayout.from_world(world, **kw),
                         lambda: jmesh.MeshLayout.from_world(world, **kw))
    if isinstance(ours, tuple):
        assert ours == theirs
    else:
        assert dataclass_values(ours) == dataclass_values(theirs)
        assert ours.world_size == theirs.world_size
        assert ours.dp_world_size == theirs.dp_world_size
        assert ours.axis_sizes() == theirs.axis_sizes()
    assert pmesh.MESH_AXES == jmesh.MESH_AXES and pmesh.ZERO_AXES == jmesh.ZERO_AXES
    assert pmesh.BATCH_AXES == jmesh.BATCH_AXES


def dataclass_values(x):
    return {f: getattr(x, f) for f in ("dp", "tp", "pp", "ep", "sp", "dp_outer")}


@pytest.mark.parametrize("dims", [(1, 2, 2, 1, 1, 2), (2, 1, 4, 1, 1, 1), (1, 1, 3, 2, 1, 1)])
def test_process_topology_matches_jax(dims):
    ours = pmesh.ProcessTopology(pmesh.MESH_AXES, dims)
    theirs = jmesh.ProcessTopology(jmesh.MESH_AXES, dims)
    assert ours.world_size() == theirs.world_size()
    for r in range(ours.world_size()):
        assert tuple(ours.get_coord(r)) == tuple(theirs.get_coord(r))
        assert ours.get_rank(**ours.get_coord(r)._asdict()) == r
    for axis in pmesh.MESH_AXES:
        assert ours.get_dim(axis) == theirs.get_dim(axis)
        assert ours.get_axis_comm_lists(axis) == theirs.get_axis_comm_lists(axis)
        for i in range(ours.get_dim(axis)):
            assert ours.get_axis_list(axis, i) == theirs.get_axis_list(axis, i)


@pytest.mark.parametrize("mesh_kw,zero_kw", [
    ({}, {"mics_shard_size": 2}), ({}, {"mics_shard_size": 4}),
    ({}, {"mics_shard_size": 8}), ({}, {"mics_shard_size": 3}),
    ({"ep": 2}, {"mics_shard_size": 4}), ({"ep": 2}, {"mics_shard_size": 3}),
    ({"dp": 4, "tp": 2}, {"mics_shard_size": 2}), ({"tp": 2}, {}),
    ({}, {"mics_shard_size": 2, "zero_hpz_partition_size": 2}),
])
def test_mics_factorization_matches_jax(mesh_kw, zero_kw):
    """The engine's layout over 8 ranks (the JAX package's 8 virtual
    devices), value for value, and the same error messages."""
    mc = types.SimpleNamespace(**{"dp": 0, "tp": 1, "pp": 1, "ep": 1, "sp": 1, **mesh_kw})
    zc = types.SimpleNamespace(**{"mics_shard_size": -1, "zero_hpz_partition_size": 1,
                                  "zero_hierarchical_dp_size": -1,
                                  "mics_hierarchical_params_gather": False, **zero_kw})

    def port():
        return pmesh.engine_layout(mc, zc, 8).axis_sizes()

    def ref():
        jmesh.reset_mesh()
        mesh = jmesh.resolve_engine_mesh(mc, zc)
        return tuple(mesh.shape[a] for a in jmesh.MESH_AXES)

    try:
        ours, theirs = _both(port, ref)
    finally:
        jmesh.reset_mesh()
    assert ours == theirs


# ---------------------------------------------------------------------------
# Planner
# ---------------------------------------------------------------------------

def _shapes():
    tiny = jtf.init_params(jtf.get_config("tiny"), jax.random.PRNGKey(0))
    unbalanced = {f"linear_{i}": {"kernel": np.zeros((13, 13)), "bias": np.zeros(13)}
                  for i in range(3)}
    unbalanced["head"] = {"kernel": np.zeros((13, 1))}
    balanced = {"linear_0": {"kernel": np.zeros((16, 16)), "bias": np.zeros(16)}}
    return {"tiny": tiny, "unbalanced": unbalanced, "balanced": balanced}


def _tp_spec(x):
    """A model-axis spec on the last dim of a 2-D+ leaf."""
    return (None,) * (len(x.shape) - 1) + ("model",) if len(x.shape) >= 2 else ()


def _path(keys):
    return "/".join(str(getattr(k, "key", k)) for k in keys)


def _at(tree, path):
    for part in path.split("/"):
        tree = tree[part]
    return tree


def _axes_by_dim(entries):
    """{mesh axis: the tensor dim it shards} of a PartitionSpec(-like)."""
    return {a: d for d, entry in enumerate(entries)
            for a in ((entry,) if isinstance(entry, str) else (entry or ()))}


@pytest.mark.parametrize("world", [2, 4, 8])
@pytest.mark.parametrize("threshold", [0, 1000])
@pytest.mark.parametrize("with_tp", [False, True])
def test_planner_dims_match_jax(world, threshold, with_tp):
    """With tensor-parallel specs: over a model axis of 1, and of 2 where
    the 8 virtual devices hold both axes (ZeRO worlds 2 and 4)."""
    for tp in ([1, 2] if with_tp and world * 2 <= 8 else [1]):
        _planner_dims_match_jax(world, threshold, with_tp, tp)


def _planner_dims_match_jax(world, threshold, with_tp, tp):
    P = jax.sharding.PartitionSpec
    mesh = jmesh.build_mesh(jmesh.MeshLayout(dp=world, tp=tp),
                            devices=jax.devices()[:world * tp])
    for name, tree in _shapes().items():
        jshapes = jax.tree_util.tree_map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), tree)
        tshapes = pplanner.walk(lambda x: torch.empty(tuple(x.shape), device="meta"),
                                tree)
        jtp = jax.tree_util.tree_map(lambda x: P(*_tp_spec(x)), tree) if with_tp else None
        ttp = pplanner.walk(_tp_spec, tree) if with_tp else None
        paths = [_path(p) for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
        for stage in range(4):
            jplan = jplanner.plan_sharding(jshapes, stage, mesh, tp_specs=jtp,
                                           persistence_threshold=threshold)
            tplan = pplanner.plan_sharding(tshapes, stage,
                                           pmesh.MeshLayout(dp=world, tp=tp),
                                           tp_specs=ttp, persistence_threshold=threshold)
            for field in ("param_specs", "master_specs", "grad_specs", "opt_specs"):
                jspecs = {_path(p): s for p, s in jax.tree_util.tree_flatten_with_path(
                    getattr(jplan, field), is_leaf=lambda s: isinstance(s, P))[0]}
                for path in paths:
                    got = {a: pl.dim for a, pl in zip(
                        pmesh.MESH_AXES, _at(getattr(tplan, field), path)) if pl.is_shard()}
                    want = _axes_by_dim(tuple(jspecs[path]))
                    assert got == want, (name, tp, stage, field, path, got, want)


def test_planner_persistence_only_on_compute_params():
    """Stage 3 with a threshold: leaves under it stay replicated as compute
    params, their masters are sharded; a leaf no dim divides stays
    replicated everywhere."""
    shapes = {"big": torch.empty(64, 32, device="meta"),
              "small": torch.empty(8, device="meta"),
              "odd": torch.empty(13, 13, device="meta")}
    plan = pplanner.plan_sharding(shapes, 3, pmesh.MeshLayout(dp=4),
                                  persistence_threshold=100)
    dim = pplanner.shard_dim
    assert dim(plan.param_specs["big"]) == 0 and dim(plan.master_specs["big"]) == 0
    assert dim(plan.param_specs["small"]) is None and dim(plan.master_specs["small"]) == 0
    assert dim(plan.param_specs["odd"]) is None and dim(plan.master_specs["odd"]) is None


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _ckpt_config():
    return {"train_batch_size": 8, "gradient_accumulation_steps": 2,
            "bf16": {"enabled": True},
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3, "weight_decay": 0.1}},
            "zero_optimization": {"stage": 3, "stage3_param_persistence_threshold": 0},
            "steps_per_print": 10 ** 9}


@pytest.fixture(scope="module")
def ckpt_run(tmp_path_factory):
    params_np = jax.tree_util.tree_map(
        np.asarray, jtf.init_params(jtf.get_config("tiny"), jax.random.PRNGKey(3)))
    batches = make_batches(4, 8, seed=5)
    tmp = tmp_path_factory.mktemp("ckpt")
    ckpt_dir = str(tmp / "ckpt")
    kw = dict(config=_ckpt_config(), params_np=params_np, batches=batches,
              ckpt_dir=ckpt_dir)
    saved = run_ranks(2, "checkpoint", tmp, mode="save", async_save=True, **kw)
    resumed = run_ranks(2, "checkpoint", tmp, mode="resume", **kw)
    loaded4 = run_ranks(4, "checkpoint", tmp, mode="load", **kw)
    return params_np, ckpt_dir, saved, resumed, loaded4


def _equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_sharded_resume_is_bit_exact(ckpt_run):
    _, ckpt_dir, saved, resumed, _ = ckpt_run
    for s, r in zip(saved, resumed):
        assert r["losses"] == s["losses"][2:]
        _equal(r["saved"], s["saved"])
        _equal(r["final"], s["final"])
        assert r["steps"] == s["steps"] == 4
    with open(os.path.join(ckpt_dir, "global_step2", "client_state.json")) as f:
        meta = json.load(f)
    assert meta["mesh_shape"] == {"pipe": 1, "data_outer": 1, "data": 2, "expert": 1,
                                  "seq": 1, "model": 1}
    with open(os.path.join(ckpt_dir, "global_step2", "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["writer_world_size"] == 2
    assert manifest["tree"]["master_params/embed"]["shape"] == [256, 64]
    assert not os.path.exists(os.path.join(ckpt_dir, "global_step2", ".incomplete"))


def test_sharded_checkpoint_loads_at_other_worlds(ckpt_run):
    """World 4 and the one-device engine (no process group) load the
    masters of the 2-rank save, bit for bit."""
    params_np, ckpt_dir, saved, _, loaded4 = ckpt_run
    for r in loaded4:
        _equal(r["saved"], saved[0]["saved"])
        assert r["steps"] == 2
    model = CausalLM("tiny", dtype=torch.bfloat16)
    cfg = {**_ckpt_config(), "train_batch_size": 4}
    engine, *_ = ds.initialize(model=model, config=cfg, device="cpu",
                               params=params_from_jax(params_np, device="cpu"))
    engine.load_checkpoint(ckpt_dir)
    one = {p: x.numpy() for p, x in tree_flatten_with_path(engine.get_params(fp32=True))}
    _equal(one, saved[0]["saved"])
    assert engine.global_steps == 2


def test_zero_to_fp32_of_sharded_checkpoint(ckpt_run):
    _, ckpt_dir, saved, _, _ = ckpt_run
    sd = get_fp32_state_dict_from_zero_checkpoint(ckpt_dir)
    _equal({k: v.numpy() for k, v in sd.items()}, saved[0]["saved"])


# ---------------------------------------------------------------------------
# APIs
# ---------------------------------------------------------------------------

def test_gathered_parameters_and_init():
    model = CausalLM("tiny", dtype=torch.bfloat16)
    with zero.Init():
        params = model.init_fn(torch.Generator().manual_seed(0), device="cpu")
    with zero.GatheredParameters(params) as g:
        assert isinstance(g.values["embed"], np.ndarray)
        np.testing.assert_array_equal(g.values["embed"], params["embed"].numpy())
    assert g.values is None
    with zero.GatheredParameters(params, to_device=True) as g:
        assert torch.equal(g.values["layers"]["wq"], params["layers"]["wq"])
        assert g.values["layers"]["wq"] is not params["layers"]["wq"]
    with pytest.raises(NotImplementedError, match="modifier_rank"):
        zero.GatheredParameters(params, modifier_rank=0)


@pytest.mark.parametrize("out_splits,in_splits", [(1, 1), (2, 1), (1, 4), (4, 2)])
def test_tiled_linear_matches_jax(out_splits, in_splits):
    rs = np.random.RandomState(0)
    x = rs.standard_normal((2, 3, 32)).astype(np.float32)
    w = rs.standard_normal((32, 24)).astype(np.float32)
    b = rs.standard_normal(24).astype(np.float32)
    want = np.asarray(jtiling.tiled_linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                           out_splits=out_splits, in_splits=in_splits))
    got = tiled_linear(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                       out_splits=out_splits, in_splits=in_splits)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    layer = TiledLinear(32, 24, out_splits=out_splits, in_splits=in_splits)
    p = layer.init(torch.Generator().manual_seed(1))
    np.testing.assert_allclose(layer.apply(p, torch.from_numpy(x)).numpy(),
                               x @ p["w"].numpy() + p["b"].numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="not divisible"):
        tiled_linear(torch.from_numpy(x), torch.from_numpy(w), out_splits=5)


def test_tiled_linear_on_zero_shards(tmp_path):
    cases = [(0, 2, 1), (0, 1, 2), (0, 2, 2), (1, 2, 1), (1, 1, 2), (1, 2, 2), (1, 3, 1)]
    for rank in run_ranks(2, "tiling", tmp_path, seed=0, cases=cases):
        for got in rank:
            assert got["err"] < 1e-4 and got["grad_err"] < 1e-4, got
