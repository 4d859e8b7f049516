"""The port's sequence parallelism (the mesh's 'seq' axis) through the
training engine, against the JAX package and against its own one-process
run, on gloo ranks on the CPU (``tests/_torch_ranks.py``; one spawn a
world, each under its own deadline).

- **Training**: ``tiny`` (4 heads) in fp64, rows of 128 tokens whose
  labels ignore a different count of positions in each row, 3 steps of
  gas 2, AdamW with weight decay, clipping at 0.05: ring attention at
  sp=2 (stage 0; remat ``nothing_saveable``, whose recompute makes the
  rotations again, counted), sp=2 x dp=2 (stage 2), tp=2 x sp=2 (stage
  0), and Ulysses at sp=2 (stage 1) and tp=2 x sp=2 (stage 3).  Losses
  and final masters against the single-device fp64 JAX engine at 5e-6
  (the golden gate's tolerance) and against the port's one-process
  trainer; every rank the same.  Dropout at sp=2 draws the one-process
  run's masks (keyed by each token's row and position).
- **Checkpoints**: saved at sp=2, loaded in a one-device engine bit for
  bit (the 'seq'-replicated state is written once).
- **Routing**: JAX's conditions and messages for "ring" and "ulysses"
  (``tests/unit/test_ulysses.py``'s unsatisfiable heads, the pipelined
  mesh, custom positions; alibi for the ring).
"""
import dataclasses

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
from deepspeed_tpu_torch.models import CausalLM
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.utils.tree import tree_flatten_with_path, tree_map

from ._torch_ranks import _run_case, make_batches, run_ranks

MODEL = "tiny"
TOL = dict(rtol=5e-6, atol=5e-6)
STEPS, TRAIN_BATCH, GAS, CLIP, SEQ = 3, 8, 2, 0.05, 128
DEADLINE = 90.0
LAYERS = 2


def _config(stage):
    return {"train_batch_size": TRAIN_BATCH, "gradient_accumulation_steps": GAS,
            "gradient_clipping": CLIP,
            "optimizer": {"type": "adamw",
                          "params": {"lr": 1e-3, "weight_decay": 0.1,
                                     "mu_dtype": "float64", "nu_dtype": "float64"}},
            "zero_optimization": {"stage": stage,
                                  "stage3_param_persistence_threshold": 0},
            "steps_per_print": 10 ** 9}


# (name, mesh, stage, model keywords)
CASES = {2: [("ring_sp2", {"sp": 2}, 0, {}),
             ("ring_sp2_remat", {"sp": 2}, 0,
              {"remat": True, "remat_policy": "nothing_saveable"}),
             ("ulysses_sp2", {"sp": 2}, 1, {"attn_impl": "ulysses"}),
             ("ring_sp2_dropout", {"sp": 2}, 0, {"dropout": 0.1})],
         4: [("ring_sp2_dp2", {"sp": 2, "dp": 2}, 2, {}),
             ("ring_tp2_sp2", {"tp": 2, "sp": 2}, 0, {}),
             ("ulysses_tp2_sp2", {"tp": 2, "sp": 2}, 3, {"attn_impl": "ulysses"})]}
IDS = [(w, i) for w in (2, 4) for i in range(len(CASES[w]))
       if "dropout" not in CASES[w][i][0]]


def _case(mesh, stage, model_kw):
    kw = dict(model_kw)
    attn = kw.pop("attn_impl", None)
    case = {"config": _config(stage), "model": MODEL, "mesh": mesh, "model_kw": kw}
    if attn:
        case["model_kw"]["attn_impl"] = attn
    return case


@pytest.fixture(scope="module")
def params_np():
    return jax.tree_util.tree_map(
        np.asarray, jtf.init_params(jtf.get_config(MODEL), jax.random.PRNGKey(2)))


@pytest.fixture(scope="module")
def batches():
    return make_batches(STEPS, TRAIN_BATCH, seed=3, seq=SEQ)


def _flat_np(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def jax_run(params_np, batches):
    """The single-device fp64 JAX engine (the parity oracle)."""
    jax.config.update("jax_enable_x64", True)
    try:
        jmesh.reset_mesh()
        mesh = jmesh.initialize_mesh(jmesh.MeshLayout(dp=1), devices=jax.devices()[:1])
        model = JaxCausalLM(dataclasses.replace(jtf.get_config(MODEL),
                                                dtype=jnp.float64))
        eng, *_ = deepspeed_tpu.initialize(
            model=model, config=_config(0),
            params=jax.tree_util.tree_map(jnp.asarray, params_np), mesh=mesh)
        losses = [float(eng.train_batch(batch={k: v.astype(np.int32)
                                               for k, v in b.items()}))
                  for b in batches]
        params = _flat_np(eng.get_params())
    finally:
        jax.config.update("jax_enable_x64", False)
        jmesh.reset_mesh()
    return {"losses": losses, "params": params}


@pytest.fixture(scope="module")
def one_process(params_np, batches):
    """The port's one-device trainer (sp=1), without and with dropout."""
    return {kw: _run_case({"config": _config(0), "model": MODEL,
                           "model_kw": {"dropout": 0.1} if kw else {}},
                          params_np, batches)
            for kw in (False, True)}


@pytest.fixture(scope="module")
def sp_runs(params_np, batches, tmp_path_factory):
    """One spawn a world: its training cases; at 2 ranks also a stage-1
    checkpoint saved at sp=2, at 4 ranks the routing errors."""
    out = {}
    for world in (2, 4):
        tmp = tmp_path_factory.mktemp(f"sp{world}")
        cases = [_case(mesh, stage, kw) for _, mesh, stage, kw in CASES[world]]
        parts = [("train", {"cases": cases, "params_np": params_np, "batches": batches})]
        if world == 2:
            parts.append(("checkpoint", {
                "config": _config(1), "params_np": params_np, "batches": batches[:2],
                "ckpt_dir": str(tmp / "ckpt"), "mode": "save", "mesh": {"sp": 2},
                "model": MODEL, "dtype": "float64"}))
        else:
            parts.append(("routing", {"model": MODEL, "seq": SEQ}))
        out[world] = {"ranks": run_ranks(world, "multi", tmp, timeout=DEADLINE,
                                         parts=parts),
                      "ckpt_dir": str(tmp / "ckpt")}
    return out


def _check(ours, losses, params):
    np.testing.assert_allclose(ours["losses"], losses, **TOL)
    assert set(ours["masters"]) == set(params)
    for k, want in params.items():
        np.testing.assert_allclose(ours["masters"][k], want, err_msg=k, **TOL)


def _name(w, i):
    return f"w{w}-{CASES[w][i][0]}"


@pytest.mark.parametrize("w,i", IDS, ids=[_name(w, i) for w, i in IDS])
def test_sp_training_matches_jax_engine(sp_runs, jax_run, w, i):
    """Ring and Ulysses over 'seq' (and composed with 'data' and 'model'):
    losses and final masters of the single-device fp64 JAX engine at 5e-6;
    every rank the same loss and the same gathered weights."""
    ranks = [rank[0] for rank in sp_runs[w]["ranks"]]
    ours = ranks[0][i]
    assert ours["sp"] == CASES[w][i][1]["sp"]
    _check(ours, jax_run["losses"], jax_run["params"])
    for other in ranks[1:]:
        assert other[i]["losses"] == ours["losses"]
        for k, v in ours["masters"].items():
            np.testing.assert_array_equal(other[i]["masters"][k], v)


@pytest.mark.parametrize("w,i", IDS, ids=[_name(w, i) for w, i in IDS])
def test_sp_matches_port_one_process(sp_runs, one_process, w, i):
    """The same run against the port's own sp=1 trainer."""
    ref = one_process[False]
    _check(sp_runs[w]["ranks"][0][0][i], ref["losses"], ref["masters"])


def test_sp_dropout_matches_one_process(sp_runs, one_process):
    """Dropout 0.1 at sp=2: each token's mask is keyed by its row and its
    position in the whole row, so the run equals the one-process run's."""
    ref = one_process[True]
    got = sp_runs[2]["ranks"][0][0][3]
    _check(got, ref["losses"], ref["masters"])
    assert got["losses"] != one_process[False]["losses"]   # the masks did something


def test_ring_rotations_under_remat(sp_runs):
    """A ring call makes sp-1 rotations; under ``nothing_saveable`` the
    backward's recompute makes them again: per step gas x layers x
    (sp-1) x 2, against x 1 without remat."""
    ranks = [rank[0] for rank in sp_runs[2]["ranks"]]
    for rank in ranks:
        assert rank[0]["ring_rotations"] == STEPS * GAS * LAYERS * 1
        assert rank[1]["ring_rotations"] == STEPS * GAS * LAYERS * 2
        assert rank[2]["ring_rotations"] == 0     # Ulysses rotates nothing


def test_sp_checkpoint_loads_at_sp1(sp_runs, params_np, batches):
    """A stage-1 checkpoint taken at sp=2 loads in a one-device engine, the
    masters bit for bit, and the resumed step equals the sp=2 run's."""
    saved = sp_runs[2]["ranks"][0][1]["saved"]
    engine, *_ = ds.initialize(model=CausalLM(MODEL, dtype=torch.float64),
                               config=_config(1), device="cpu",
                               params=tree_map(lambda x: x.double(),
                                               params_from_jax(params_np, "cpu")))
    engine.load_checkpoint(sp_runs[2]["ckpt_dir"])
    got = {p: x.numpy() for p, x in tree_flatten_with_path(engine.get_params())}
    assert set(got) == set(saved)
    for k in saved:
        np.testing.assert_array_equal(got[k], saved[k], err_msg=k)
    assert engine.global_steps == 2


def test_seq_routing_errors(sp_runs):
    """JAX's conditions and messages on a 'seq' axis of 4 (2 with a model
    axis of 2): Ulysses needs Hkv % (sp*tp), an unpipelined mesh and
    default positions; "ring" needs Hq % tp and raises on alibi; both run
    where the conditions hold."""
    errs = sp_runs[4]["ranks"][0][1]
    assert "ulysses attention unsatisfiable" in errs["ulysses_heads"]
    assert "Hkv=2 % sp*tp=4" in errs["ulysses_heads"]
    assert "pipe=1" in errs["ulysses_pipe"]
    assert "default positions" in errs["ulysses_positions"]
    assert "ring attention requested but unsatisfiable" in errs["ring_heads"]
    assert "Hq=3 % tp=2" in errs["ring_heads"]
    assert "non-alibi" in errs["ring_alibi"]
    assert errs["ring_ok"] is None and errs["ulysses_ok"] is None


def test_sequence_cut_derives_labels_and_positions_on_the_whole_row():
    """``shard_sequence``: the default labels are the whole row's shift (the
    boundary token's label comes from the next slice), positions start at
    the slice's offset, and an uneven cut raises."""
    m = CausalLM(MODEL)
    ids = torch.arange(16).reshape(2, 8)
    parts = [m.shard_sequence({"input_ids": ids}, i, 2) for i in range(2)]
    assert parts[0]["labels"][0].tolist() == [1, 2, 3, 4]
    assert parts[1]["labels"][0].tolist() == [5, 6, 7, -100]
    assert [p["seq_offset"] for p in parts] == [0, 4]
    assert parts[1]["seq_len"] == 8
    with pytest.raises(ValueError, match="does not split"):
        m.shard_sequence({"input_ids": ids}, 0, 3)
