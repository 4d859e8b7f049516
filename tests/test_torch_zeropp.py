"""The port's ZeRO++ (``ops/quantizer`` collectives, ``runtime/zero/
zeropp.py``, hpZ and the hierarchical DP size) against the JAX package.

The collectives run over 2 and 4 gloo ranks (``tests/_torch_ranks.py``)
and, in this process, inside ``shard_map`` over as many of the virtual
CPU devices of tests/conftest.py, on the same numpy inputs: the codes
and scales are bit-equal (the same round-half-even arithmetic), and the
gathered, reduced and back-propagated values agree within 1e-6 (the
dequantized values are exact products of codes and scales; the sums run
in the same order, so in fact they match to the last bit, but the bound
leaves room for a different fused multiply).  The engine paths train the
``tiny`` model from JAX's tree at 4 ranks against the JAX engine at 4
devices in the same mode: the compute params the first step reads are
bit-equal under every quantized mode; the losses, gradient norms and
masters of bf16 runs agree within the plain runs' gap (plus JAX's own quantization shift
where a mode quantizes); hpZ and the hierarchical DP size without
quantization equal plain ZeRO-3 within 1e-6 in fp32.  Besides, every
ZeRO++ mode's losses stay within JAX's own qwZ bound against plain
ZeRO-3 (``tests/unit/test_zeropp.py``: rtol 0.05, atol 0.02), and the
gathers of every sharded, non-persistent leaf ride int8 (the comms
logger's bytes by dtype), their count equal to ``num_quantized_leaves``.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import deepspeed_tpu
from deepspeed_tpu.ops import quantizer as jq
from deepspeed_tpu.parallel import mesh as jmesh

from ._torch_ranks import make_batches, run_ranks

QWZ_BOUND = dict(rtol=0.05, atol=0.02)   # tests/unit/test_zeropp.py:42
VALUE_TOL = dict(rtol=1e-6, atol=1e-6)
STEPS, ROWS = 3, 8


def _inputs(n, seed=0):
    rs = np.random.RandomState(seed)
    xs = [rs.randn(8, 24).astype(np.float32) * (r + 1) for r in range(n)]
    dys = [rs.randn(8 * n, 24).astype(np.float32) for r in range(n)]
    gs = [rs.randn(8 * n, 20).astype(np.float32) for r in range(n)]
    return xs, dys, gs


def _jax_collectives(layout, xs, dys, gs, bits):
    n = len(xs)
    jmesh.reset_mesh()
    mesh = jmesh.initialize_mesh(jmesh.MeshLayout(**layout), devices=jax.devices()[:n])
    axis = "data" if layout.get("dp_outer", 1) == 1 else ("data_outer", "data")
    spec = P(axis)

    def codes(x):
        q, s = jq.quantize_blockwise(x, block=64, bits=bits)
        return q[None], s[None]

    out = {}
    q, s = jmesh.shard_map_compat(codes, mesh, in_specs=(spec,),
                                  out_specs=(spec, spec))(jnp.concatenate(xs))
    out["q"], out["scale"] = np.asarray(q), np.asarray(s)
    for gb in (None, 8):
        def gather(x, dy, gb=gb):
            f = lambda v: jq.quantized_all_gather(  # noqa: E731
                v, axis, gather_dim=0, block=64, bits=bits, out_dtype=jnp.float32,
                grad_bits=gb)
            y, vjp = jax.vjp(f, x)
            return y[None], vjp(dy[0])[0]

        y, dx = jmesh.shard_map_compat(gather, mesh, in_specs=(spec, spec),
                                       out_specs=(spec, spec))(
            jnp.concatenate(xs), jnp.stack(dys))
        out[f"gather{gb}"], out[f"dx{gb}"] = np.asarray(y), np.asarray(dx)

    def rs_fn(g):
        return jq.quantized_reduce_scatter(g[0], "data", scatter_dim=0, block=64,
                                           bits=bits)

    out["rs"] = np.asarray(jmesh.shard_map_compat(
        rs_fn, mesh, in_specs=(spec,), out_specs=spec)(jnp.stack(gs)))
    if layout.get("dp_outer", 1) > 1:
        def hier(g):
            return jq.hierarchical_quantized_reduce_scatter(
                g[0], "data", "data_outer", scatter_dim=0, block=64, bits=bits)

        out["hier"] = np.asarray(jmesh.shard_map_compat(
            hier, mesh, in_specs=(spec,), out_specs=spec)(jnp.stack(gs)))
    jmesh.reset_mesh()
    return out


@pytest.mark.parametrize("layout,bits", [
    ({"dp": 2}, 8), ({"dp": 4}, 8), ({"dp": 2, "dp_outer": 2}, 8), ({"dp": 2}, 4)],
    ids=["dp2-int8", "dp4-int8", "dp2x2-int8", "dp2-int4"])
def test_quantized_collectives_match_jax(layout, bits, tmp_path):
    n = layout["dp"] * layout.get("dp_outer", 1)
    xs, dys, gs = _inputs(n)
    ranks = run_ranks(n, "quant_coll", tmp_path, layout=layout, xs=xs, dys=dys, gs=gs,
                      bits=bits)
    ref = _jax_collectives(layout, xs, dys, gs, bits)
    nq = ref["q"].shape[1]
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["q"], ref["q"][r])           # codes
        np.testing.assert_array_equal(got["scale"], ref["scale"][r])   # scales
        for key in ("gatherNone", "gather8"):
            np.testing.assert_allclose(got[key], ref[key][r], **VALUE_TOL)
        for key in ("dxNone", "dx8"):
            np.testing.assert_allclose(got[key], ref[key][8 * r:8 * (r + 1)], **VALUE_TOL)
        k = got["rs"].shape[0]   # each rank's reduced chunk, stacked in rank order
        np.testing.assert_allclose(got["rs"], ref["rs"][k * r:k * (r + 1)], **VALUE_TOL)
        rows = gs[0].shape[0] // n
        if "hier" in ref:
            np.testing.assert_allclose(got["hier"], ref["hier"][rows * r:rows * (r + 1)],
                                       **VALUE_TOL)
        # the wire: int8 codes (two int4 codes a byte) and fp32 scales only
        assert set(got["dtypes"]["all_gather"]) == {"int8", "float32"}
        assert set(got["dtypes"]["all_to_all"]) == {"int8", "float32"}
        assert nq == got["q"].shape[0]


def _config(stage=3, bf16=True, **zc):
    return {"train_batch_size": ROWS, "gradient_accumulation_steps": 1,
            **({"bf16": {"enabled": True}} if bf16 else {}),
            "comms_logger": {"enabled": True},
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
            "zero_optimization": {"stage": stage, "stage3_param_persistence_threshold": 0,
                                  **zc},
            "steps_per_print": 10 ** 9}


MODES = {"plain": {}, "qwz": {"zero_quantized_weights": True},
         "qgz": {"zero_quantized_gradients": True},
         "qwz_qgz": {"zero_quantized_weights": True, "zero_quantized_gradients": True},
         "hpz2_qwz_qgz": {"zero_hpz_partition_size": 2, "zero_quantized_weights": True,
                          "zero_quantized_gradients": True},
         "hpz2": {"zero_hpz_partition_size": 2},
         "hier2_qgz": {"zero_hierarchical_dp_size": 2, "zero_quantized_gradients": True},
         "hier2": {"zero_hierarchical_dp_size": 2}}
QUANTIZED = [m for m in MODES if any(k.startswith("zero_quantized") for k in MODES[m])]
# the layouts that quantize nothing: plain ZeRO-3's numbers in another order
LAYOUTS = ("hpz2", "hier2")
FP32_MODES = ("plain",) + LAYOUTS

# The port against the JAX engine in the same mode, bf16, from the same
# tree and batches.  Masters are compared by the size of their difference
# relative to the size of the update (||port - jax|| / ||jax - init||):
# bf16 noise flips the first Adam steps of near-zero gradients, so an
# element may sit ~lr off while the update as a whole agrees (a wrong
# piece order or a mis-scaled reduce decorrelates the updates, ~1.4).
# Measured on the CPU: the plain runs differ by 1.37e-4 in the loss and
# 0.047 in the update; JAX's own quantization moves its losses by up to
# 4.7e-4 and its update by up to 0.105 from its plain run.  The plain
# bounds sit above the plain gap; the quantized bounds are the plain gap
# plus twice JAX's largest quantization shift (the two sides quantize
# values that already differ by the plain gap).  The reported gradient
# norms differ by 0.29% in the plain runs and by at most 0.33% in the
# quantized ones; both are held at 0.5% (Adam's update hides a mis-scaled
# gradient reduce, the norm does not).
PLAIN_GAP = {"loss": 2e-4, "update": 0.06, "norm": 5e-3}
QUANT_GAP = {"loss": 1.1e-3, "update": 0.26, "norm": 5e-3}
FP32_TOL = dict(rtol=1e-6, atol=1e-6)     # the port's layouts against its plain ZeRO-3
TRAJ_TOL = dict(rtol=1e-5, atol=1e-5)     # the port against the JAX engine, fp32


@pytest.fixture(scope="module")
def params_np():
    from deepspeed_tpu.models import transformer as jtf

    return jax.tree_util.tree_map(np.asarray, jtf.init_params(
        jtf.get_config("tiny"), jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def zpp_runs(params_np, tmp_path_factory):
    batches = make_batches(STEPS, ROWS)
    cases = [{"config": _config(**zc), "params_np": params_np, "view": True}
             for zc in MODES.values()]
    cases += [{"config": _config(bf16=False, **MODES[m]), "params_np": params_np,
               "dtype": "float32"} for m in FP32_MODES]
    ranks = run_ranks(4, "item10", tmp_path_factory.mktemp("zpp"), timeout=300,
                      cases=cases, batches=batches)
    runs = {name: [r[i] for r in ranks] for i, name in enumerate(MODES)}
    fp32 = {name: ranks[0][len(MODES) + i] for i, name in enumerate(FP32_MODES)}
    return runs, fp32, batches


def _jax_zpp_run(params_np, zc, batches, fp32=False):
    """The JAX engine at 4 devices (hpZ and the hierarchical size on the
    ('data_outer', 'data') mesh they resolve to): losses, fp32 masters,
    and under qwZ/qgZ the compute params its first step reads."""
    import dataclasses

    from deepspeed_tpu.models import CausalLM as JaxCausalLM
    from deepspeed_tpu.models import transformer as jtf

    outer = zc.get("zero_hpz_partition_size", zc.get("zero_hierarchical_dp_size", 1))
    jmesh.reset_mesh()
    mesh = jmesh.initialize_mesh(jmesh.MeshLayout(dp=4 // outer, dp_outer=outer),
                                 devices=jax.devices()[:4])
    cfg = _config(bf16=not fp32, **zc)
    cfg.pop("comms_logger")
    mcfg = jtf.get_config("tiny")
    if fp32:
        mcfg = dataclasses.replace(mcfg, dtype=jnp.float32)
    eng, *_ = deepspeed_tpu.initialize(model=JaxCausalLM(mcfg), config=cfg,
                                       params=params_np, mesh=mesh)

    def by_path(tree):
        return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x, np.float32)
                for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}

    view = (by_path(jax.jit(eng._compute_cast)(eng.state.master_params))
            if eng._compute_cast is not None else None)
    losses, norms = [], []
    for b in batches:
        losses.append(float(eng.train_batch(batch={k: v.astype(np.int32)
                                                   for k, v in b.items()})))
        norms.append(float(eng.get_global_grad_norm()))
    out = {"losses": losses, "norms": norms, "masters": by_path(eng.get_params(fp32=True)),
           "view": view}
    jmesh.reset_mesh()
    return out


@pytest.fixture(scope="module")
def jax_runs(params_np, zpp_runs):
    batches = zpp_runs[2]
    return ({m: _jax_zpp_run(params_np, zc, batches) for m, zc in MODES.items()},
            {m: _jax_zpp_run(params_np, MODES[m], batches, fp32=True) for m in FP32_MODES})


def _update_gap(got: dict, ref: dict, init: dict) -> float:
    """||got - ref|| / ||ref - init|| over every leaf."""
    d = np.concatenate([(got[k] - ref[k]).ravel() for k in ref])
    u = np.concatenate([(ref[k] - init[k]).ravel() for k in ref])
    return float(np.linalg.norm(d) / np.linalg.norm(u))


def _init_by_path(params_np) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x, np.float32)
            for path, x in jax.tree_util.tree_flatten_with_path(params_np)[0]}


@pytest.mark.parametrize("mode", [m for m in MODES if m != "plain"])
def test_zeropp_losses_within_jax_bound(zpp_runs, mode):
    runs = zpp_runs[0]
    base, got = runs["plain"][0], runs[mode][0]
    assert np.isfinite(got["losses"]).all()
    np.testing.assert_allclose(got["losses"], base["losses"], **QWZ_BOUND)
    # every rank reports the same global loss
    for r in runs[mode][1:]:
        np.testing.assert_allclose(r["losses"], got["losses"], rtol=1e-6)


@pytest.mark.parametrize("mode", QUANTIZED)
def test_zeropp_compute_view_equals_jax(zpp_runs, jax_runs, mode):
    """The compute params the first step reads, gathered (under qwZ from
    int8 codes of the fp32 master shards; under hpZ through the quantized
    outer hop and the inner bf16 gather), equal the JAX engine's ZeRO++
    cast of the same masters value for value: codes, scales, pieces and
    their order agree."""
    got, ref = zpp_runs[0][mode][0]["view"], jax_runs[0][mode]["view"]
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("mode", list(MODES))
def test_zeropp_trajectory_matches_jax_same_mode(zpp_runs, jax_runs, params_np, mode):
    """Each mode's per-step losses and final masters against the JAX
    engine's in the same mode (bounds above: the plain gap for the modes
    that quantize nothing, plus JAX's own quantization shift for the
    others)."""
    got, ref = zpp_runs[0][mode][0], jax_runs[0][mode]
    bound = QUANT_GAP if mode in QUANTIZED else PLAIN_GAP
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=0, atol=bound["loss"])
    np.testing.assert_allclose(got["norms"], ref["norms"], rtol=bound["norm"], atol=0)
    gap = _update_gap(got["masters"], ref["masters"], _init_by_path(params_np))
    assert gap <= bound["update"], (mode, gap)


@pytest.mark.parametrize("mode", LAYOUTS)
def test_unquantized_layouts_equal_plain_zero3(zpp_runs, jax_runs, mode):
    """hpZ and the hierarchical DP size without quantization are plain
    ZeRO-3 with the masters in other pieces and the gradient summed in
    two hops: in fp32 (where the bf16 rounding of the first Adam steps
    does not amplify the sum order) the losses and masters equal the
    port's plain ZeRO-3 within 1e-6, and the JAX engine's in the same
    mode within the fp32 trajectory bound."""
    _, fp32, _ = zpp_runs
    got, plain = fp32[mode], fp32["plain"]
    np.testing.assert_allclose(got["losses"], plain["losses"], **FP32_TOL)
    np.testing.assert_allclose(got["norms"], plain["norms"], **FP32_TOL)
    for k, v in plain["masters"].items():
        np.testing.assert_allclose(got["masters"][k], v, err_msg=k, **FP32_TOL)
    ref = jax_runs[1][mode]
    np.testing.assert_allclose(got["losses"], ref["losses"], **TRAJ_TOL)
    np.testing.assert_allclose(got["norms"], ref["norms"], **TRAJ_TOL)
    for k, v in ref["masters"].items():
        np.testing.assert_allclose(got["masters"][k], v, err_msg=k, **TRAJ_TOL)


@pytest.mark.parametrize("mode", ["qwz", "qwz_qgz", "qgz", "hpz2_qwz_qgz", "hier2_qgz"])
def test_zeropp_wire_is_int8(zpp_runs, mode):
    """qwZ: every gather of a sharded compute leaf moves int8 codes (one
    gather a read: STEPS x (the forward's and the remat-free backward's
    reads)); qgZ: the gradient reduce is an int8 all-to-all and no plain
    reduce-scatter of those leaves runs besides."""
    runs = zpp_runs[0]
    got, plain = runs[mode][0], runs["plain"][0]
    nq = got["num_quantized"]
    assert nq == len(plain["masters"])   # threshold 0: every leaf is sharded
    ag = got["dtypes"]["all_gather"]
    plain_gathers = plain["dtypes"]["all_gather"]["bfloat16"]["calls"]
    if MODES[mode].get("zero_quantized_weights") and "hpz" not in mode:
        assert ag["int8"]["calls"] == plain_gathers
        assert "bfloat16" not in ag
    if mode == "hpz2_qwz_qgz":   # the outer hop: one int8 gather a leaf a step
        # (plus the initial compute view at init, before the logger reset)
        assert ag["int8"]["calls"] == nq * STEPS
    if MODES[mode].get("zero_quantized_gradients"):
        assert got["dtypes"]["all_to_all"]["int8"]["calls"] > 0
        if "hpz" not in mode:
            assert "reduce_scatter" not in got["dtypes"]


def test_num_quantized_leaves_counts_the_sharded_leaves(tmp_path):
    """A persistence threshold keeps the small leaves (norm scales) on the
    plain path: they are not counted and never gathered in int8."""
    cfg = _config(zero_quantized_weights=True)
    cfg["zero_optimization"]["stage3_param_persistence_threshold"] = 1000
    ranks = run_ranks(2, "item10", tmp_path, cases=[{"config": cfg, "steps": 1}],
                      batches=make_batches(1, ROWS))
    got = ranks[0][0]
    # tiny: 12 leaves, 3 of them below 1000 elements (the norm scales)
    assert got["num_quantized"] == 9
    # the persistent leaves' only gathers are their bf16 compute params
    # rebuilt from the master shards after the update: one each a step
    assert got["dtypes"]["all_gather"]["bfloat16"]["calls"] == 3


@pytest.mark.parametrize("mode", QUANTIZED)
def test_jax_zeropp_engine_within_bound_of_port(zpp_runs, jax_runs, params_np, mode):
    """Quantization moves the port as far as it moves JAX: from the same
    tree, each engine's run in a quantized mode stays within JAX's qwZ
    bound of its own plain run, and the port's update moves off its plain
    run's by between half and twice what JAX's moves off its own (zero
    would mean nothing was quantized)."""
    init = _init_by_path(params_np)
    port, jx = zpp_runs[0], jax_runs[0]
    np.testing.assert_allclose(jx[mode]["losses"], jx["plain"]["losses"], **QWZ_BOUND)
    np.testing.assert_allclose(port[mode][0]["losses"], port["plain"][0]["losses"],
                               **QWZ_BOUND)
    ours = _update_gap(port[mode][0]["masters"], port["plain"][0]["masters"], init)
    theirs = _update_gap(jx[mode]["masters"], jx["plain"]["masters"], init)
    assert 0.5 <= ours / theirs <= 2.0, (ours, theirs)


@pytest.mark.parametrize("zero_kw", [
    {"zero_hpz_partition_size": 2}, {"zero_hpz_partition_size": 4},
    {"zero_hierarchical_dp_size": 2}, {"zero_hpz_partition_size": 3},
    {"zero_hierarchical_dp_size": 2, "mics_shard_size": 2},
    {"mics_shard_size": 2, "mics_hierarchical_params_gather": True}])
def test_hpz_factorization_matches_jax(zero_kw):
    """The layouts of hpZ and the hierarchical DP size over 8 ranks (the
    JAX package's 8 virtual devices), value for value, and its errors."""
    import types

    from deepspeed_tpu_torch.parallel import mesh as pmesh

    mc = types.SimpleNamespace(dp=0, tp=1, pp=1, ep=1, sp=1)
    zc = types.SimpleNamespace(**{"mics_shard_size": -1, "zero_hpz_partition_size": 1,
                                  "zero_hierarchical_dp_size": -1,
                                  "mics_hierarchical_params_gather": False, **zero_kw})

    def run(fn):
        try:
            return fn(), None
        except Exception as e:   # noqa: BLE001
            return None, (type(e), str(e))

    ours = run(lambda: pmesh.engine_layout(mc, zc, 8).axis_sizes())
    jmesh.reset_mesh()
    theirs = run(lambda: tuple(jmesh.resolve_engine_mesh(mc, zc).shape[a]
                               for a in jmesh.MESH_AXES))
    jmesh.reset_mesh()
    assert ours == theirs


@pytest.mark.parametrize("zero,err", [
    ({"stage": 2, "zero_quantized_weights": True}, "ZeRO++ quantized collectives require stage 3"),
    ({"stage": 2, "zero_hpz_partition_size": 2}, "zero_hpz_partition_size (ZeRO++ hpZ) requires stage 3"),
    ({"stage": 1, "zero_hierarchical_dp_size": 2}, "zero_hierarchical_dp_size (hierarchical qgZ) requires stage 3"),
    ({"stage": 3, "zero_hierarchical_dp_size": 2, "zero_hpz_partition_size": 2},
     "zero_hierarchical_dp_size and zero_hpz_partition_size both"),
    ({"stage": 3, "mics_hierarchical_params_gather": True},
     "mics_hierarchical_params_gather requires mics_shard_size > 0"),
])
def test_zeropp_config_refusals_match_jax(zero, err):
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

    cfg = {"train_batch_size": 2, "zero_optimization": zero}
    with pytest.raises(Exception) as theirs:
        JaxConfig(cfg)
    with pytest.raises(ValueError) as ours:
        DeepSpeedConfig(cfg)
    assert err in str(ours.value) and err in str(theirs.value)


def test_zeropp_refuses_fp32_compute():
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import CausalLM

    cfg = {"train_batch_size": 2,
           "zero_optimization": {"stage": 3, "zero_quantized_weights": True}}
    # one device: no partition, nothing to quantize; the JAX message where
    # a process group makes the plan
    from deepspeed_tpu_torch.runtime.zero.zeropp import zeropp_settings

    with pytest.raises(ValueError, match="require bf16 or fp16 compute"):
        zeropp_settings(ds.runtime.config.DeepSpeedConfig(cfg).zero_config, False)
    assert ds.initialize(model=CausalLM("tiny", dtype=__import__("torch").float32),
                         config=cfg, device="cpu")[0] is not None


def test_zpp4_7b_rehearsal(tmp_path):
    """The 4-card configuration ``zpp4_7b`` at the tiny model's size over 4
    gloo ranks: ZeRO-3 with qwZ, qgZ and hpZ=2 at dp=4 against plain
    ZeRO-3, losses within the qwZ bound, all-gather bytes by dtype."""
    batches = make_batches(2, 4)
    cases = [{"config": {**_config(), "train_batch_size": 4}},
             {"config": {**_config(zero_hpz_partition_size=2, zero_quantized_weights=True,
                                   zero_quantized_gradients=True), "train_batch_size": 4}}]
    ranks = run_ranks(4, "item10", tmp_path, timeout=300, cases=cases, batches=batches)
    plain, zpp = ranks[0]
    np.testing.assert_allclose(zpp["losses"], plain["losses"], **QWZ_BOUND)
    assert zpp["dtypes"]["all_gather"]["int8"]["bytes"] > 0
