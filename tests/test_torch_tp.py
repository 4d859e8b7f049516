"""The port's tensor parallelism (Megatron over the mesh's 'model' axis)
against the JAX package and against its own unsharded path, on gloo ranks
on the CPU (``tests/_torch_ranks.py``, jax-free; each spawn under its own
deadline, so a hung collective fails its test).

- **Training**: ``tiny-gqa`` (8 heads, 2 KV heads) in fp64 at tp=2 (2
  ranks, stages 0-3, and remat under ``nothing_saveable`` at stage 3 and
  ``save_matmuls`` at stage 0, whose backward recomputes run the
  model-axis collectives again) and tp=2 x dp=2 (4 ranks, stages 0-3 and
  MiCS with one shard per replica), 3 steps of gas 2 over batches whose rows carry
  different counts of ignored labels, AdamW with weight decay, clipping at
  0.05 (active on every step).  Losses and final masters against the
  single-device fp64 JAX engine at rtol/atol 5e-6 (the golden gate's
  tolerance: JAX keeps fp32 masters, both compute the loss in fp32), and
  against the port's one-process trainer at the same tolerance (the
  vocab-parallel loss sums its exponentials in two halves, so the fp32
  loss rounds differently from ``torch.logsumexp``: observed 2e-6 in the
  masters).  Every rank reports the same loss and gathers the same
  weights; each rank's local masters are the model-major cut (the ZeRO
  piece within its model-axis shard) of the whole tree; dropout at tp=2 x
  dp=2 draws the one-process run's masks (keyed by the data-parallel row).
- **Checkpoints**: saved at tp=2 x dp=2, stage 3, bf16 over fp32 masters;
  the resume is bit-exact; loads at tp=1 x dp=4 and in a one-device engine
  give the saved masters bit for bit; ``zero_to_fp32`` consolidates the
  shards; ``reshard_checkpoint`` writes per-rank files equal to the slices.
- **Inference and serving** (fp32 ``tiny-gqa``, tp=2): ``forward`` logits
  against JAX's single-device ``init_inference`` at atol 2e-5; ``generate``
  token-exact against the port's unsharded engine (greedy and sampled
  lanes) and against JAX's ``generate`` (greedy; the two packages' samplers
  draw from different generators); paged serving token-exact against the
  unsharded ``ServingEngine`` and ``generate``, on both ranks, including
  under deadlines; per-device pool bytes times tp equal the total; the
  page invariant holds; a model axis that does not divide the KV heads is
  refused before any collective.
- **Layout**: ``param_specs`` equals the JAX package's, entry for entry;
  the sharded init's shards equal the slices of the full init (default
  and layer-streamed); one seed draws the same weights at tp=2 as at tp=1.
- **Uneven shards** (padded with zeros): llama-740m's 14 heads at tp=4,
  gpt2's 50257-token vocabulary at tp=2, ``tiny-gqa``'s 2 KV heads at
  tp=4 (gathered per query head) and ``tiny`` with an FFN of 130 at
  tp=4, at narrow widths: losses and masters against the single-device
  fp64 JAX engine at 5e-6, the pads (weights and Adam moments) exactly 0
  after the steps, logits and greedy tokens against JAX's fp32
  ``generate``; checkpoints, ``zero_to_fp32``, ``reshard_checkpoint`` and
  the gathered tree carry the true shapes.
- **Generic models** (DTensor sharding propagation): the JAX contracts
  (a column-parallel ``linear_0``, a falling loss; the tp=2 forward of a
  bare ``apply_fn`` within rtol 1e-5 / atol 1e-6 of one device) and
  tp=2 against the port's one-process run.
- **Serving mesh over the first ranks** and the **teardown** that closes
  captured graphs first.
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
from deepspeed_tpu_torch.checkpoint import (get_fp32_state_dict_from_zero_checkpoint,
                                            load_mp_shard, reshard_checkpoint)
from deepspeed_tpu_torch.inference import SamplingParams
from deepspeed_tpu_torch.inference.engine import place_params
from deepspeed_tpu_torch.models import CausalLM
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.parallel.mesh import MeshLayout
from deepspeed_tpu_torch.parallel.tensor_parallel import padded as padded_extent
from deepspeed_tpu_torch.parallel.tensor_parallel import spec_dim, spec_paths, true_piece
from deepspeed_tpu_torch.utils.tree import tree_flatten_with_path, tree_leaves

from ._torch_ranks import (SimpleTPModel, _requests, _run_case, make_batches, run_ranks,
                           simple_batch, tiny_lm_apply, tiny_lm_params)

MODEL = "tiny-gqa"
TOL = dict(rtol=5e-6, atol=5e-6)
STEPS, TRAIN_BATCH, GAS, CLIP = 3, 8, 2, 0.05
DEADLINE = 90.0     # seconds per spawn of ranks


def _config(stage, mics=-1, **extra):
    cfg = {"train_batch_size": TRAIN_BATCH, "gradient_accumulation_steps": GAS,
           "gradient_clipping": CLIP,
           "optimizer": {"type": "adamw",
                         "params": {"lr": 1e-3, "weight_decay": 0.1,
                                    "mu_dtype": "float64", "nu_dtype": "float64"}},
           "zero_optimization": {"stage": stage, "mics_shard_size": mics,
                                 "stage3_param_persistence_threshold": 0},
           "steps_per_print": 10 ** 9}
    cfg.update(extra)
    return cfg


@pytest.fixture(scope="module")
def params_np():
    return jax.tree_util.tree_map(
        np.asarray, jtf.init_params(jtf.get_config(MODEL), jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def batches():
    return make_batches(STEPS, TRAIN_BATCH)


def _flat_np(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def jax_run(params_np, batches):
    """The single-device fp64 JAX engine (its tp mesh is skip-marked for
    CPU-XLA drift, so the reference is one device)."""
    jax.config.update("jax_enable_x64", True)
    try:
        jmesh.reset_mesh()
        mesh = jmesh.initialize_mesh(jmesh.MeshLayout(dp=1), devices=jax.devices()[:1])
        model = JaxCausalLM(dataclasses.replace(jtf.get_config(MODEL),
                                                dtype=jnp.float64))
        eng, *_ = deepspeed_tpu.initialize(
            model=model, config=_config(0),
            params=jax.tree_util.tree_map(jnp.asarray, params_np), mesh=mesh)
        losses, norms = [], []
        for b in batches:
            losses.append(float(eng.train_batch(batch={
                k: v.astype(np.int32) for k, v in b.items()})))
            norms.append(float(eng.get_global_grad_norm()))
        params = _flat_np(eng.get_params())
    finally:
        jax.config.update("jax_enable_x64", False)
        jmesh.reset_mesh()
    return {"losses": losses, "grad_norms": norms, "params": params}


@pytest.fixture(scope="module")
def one_process(params_np, batches):
    """The port's one-device trainer (no process group)."""
    return _run_case({"config": _config(0), "model": MODEL}, params_np, batches)


# (mesh, stage, mics, remat policy or None); remat recomputes each layer in
# the backward, its all-reduces included
CASES = {2: [({"tp": 2}, s, -1, None) for s in range(4)]
         + [({"tp": 2}, 3, -1, "nothing_saveable"), ({"tp": 2}, 0, -1, "save_matmuls")],
         4: [({"tp": 2, "dp": 2}, s, -1, None) for s in range(4)] + [(None, 3, 1, None)]}
CASE_IDS = [(w, i) for w in (2, 4) for i in range(len(CASES[w]))]


def _case(mesh, stage, mics, remat=None, **kw):
    if remat:
        kw["model_kw"] = {**kw.get("model_kw", {}), "remat": True, "remat_policy": remat}
    if mesh is None:   # MiCS: the config's mesh block, one shard per replica
        return {"config": _config(stage, mics, mesh={"tp": 2}), "model": MODEL, **kw}
    return {"config": _config(stage, mics), "model": MODEL, "mesh": mesh, **kw}


# Uneven shards: (name, JAX/port config, overrides, model axis, stage)
UNEVEN = {"heads14": ("llama-740m", {"hidden_size": 56, "intermediate_size": 64,
                                     "num_layers": 2, "vocab_size": 256,
                                     "max_seq_len": 128}, 4, 3),
          "vocab50257": ("gpt2-125m", {"hidden_size": 32, "intermediate_size": 64,
                                       "num_layers": 2, "num_heads": 4,
                                       "max_seq_len": 128}, 2, 0),
          "gqa_kv2": ("tiny-gqa", {}, 4, 0),
          "ffn130": ("tiny", {"intermediate_size": 130}, 4, 0)}
UNEVEN_IDS = list(UNEVEN)
GENERIC_STEPS, GENERIC_ROWS, HID = 5, 16, 16


def _uneven_params(name):
    model, kw, _, _ = UNEVEN[name]
    return jax.tree_util.tree_map(np.asarray, jtf.init_params(
        jtf.get_config(model, **kw), jax.random.PRNGKey(11)))


def _uneven_batches(name):
    model, kw, _, _ = UNEVEN[name]
    return make_batches(STEPS, TRAIN_BATCH, seed=7,
                        vocab=jtf.get_config(model, **kw).vocab_size)


def _uneven_case(name):
    model, kw, n, stage = UNEVEN[name]
    return {"config": _config(stage), "model": model, "model_kw": kw,
            "mesh": {"tp": n},
            "params_np": _uneven_params(name), "batches": _uneven_batches(name)}


def _uneven_generate(name):
    model, kw, n, _ = UNEVEN[name]
    tokens, prompts, *_ = _serve_inputs()
    return {"model": model, "model_kw": kw, "tp": n, "params_np": _uneven_params(name),
            "tokens": tokens, "prompts": prompts, "max_new": MAX_NEW}


@pytest.fixture(scope="module")
def tp_spawn(params_np, batches, tmp_path_factory):
    """One spawn a world, each rank running several programs in turn: the
    even training cases (the 4-rank spawn adds a dropout case, stage 0,
    tp=2 x dp=2), the uneven ones of that world's model axis, their
    ``generate``; at 2 ranks also the seed check, the generic models and
    the serving mesh over the first rank; at 4 ranks an uneven checkpoint."""
    out = {}
    for world in (2, 4):
        cases = [_case(*c) for c in CASES[world]]
        uneven = [u for u in UNEVEN_IDS if UNEVEN[u][2] == world]
        if world == 4:
            cases.append(_case({"tp": 2, "dp": 2}, 0, -1, None, model_kw={"dropout": 0.1}))
        else:
            cases.append({"config": _config(0), "model": MODEL, "mesh": {"tp": 2},
                          "no_params": True, "batches": []})
        cases += [_uneven_case(u) for u in uneven]
        tmp = tmp_path_factory.mktemp(f"tp{world}")
        parts = [("train", {"cases": cases, "params_np": params_np, "batches": batches}),
                 ("generate", {"cases": [_uneven_generate(u) for u in uneven]})]
        if world == 2:
            parts += [("generic", {"config": {"train_batch_size": GENERIC_ROWS,
                                              "optimizer": {"type": "adamw",
                                                            "params": {"lr": 1e-2}},
                                              "steps_per_print": 10 ** 9},
                                   "steps": GENERIC_STEPS, "rows": GENERIC_ROWS,
                                   "hidden": HID, "tp": 2}),
                      ("subset", {"model": MODEL, "params_np": params_np,
                                  "prompts": _serve_inputs()[1], "max_new": MAX_NEW})]
        else:
            ckpt_dir = str(tmp / "uneven_ckpt")
            parts.append(("checkpoint", {
                "config": _ckpt_config(), "params_np": _uneven_params("heads14"),
                "batches": _uneven_batches("heads14")[:2], "ckpt_dir": ckpt_dir,
                "mode": "save", "mesh": {"tp": 4}, "model": UNEVEN["heads14"][0],
                "model_kw": UNEVEN["heads14"][1]}))
        out[world] = {"ranks": run_ranks(world, "multi", tmp, timeout=DEADLINE,
                                         parts=parts),
                      "n_even": len(CASES[world]) + 1, "uneven": uneven,
                      "ckpt_dir": None if world == 2 else ckpt_dir}
    return out


@pytest.fixture(scope="module")
def tp_runs(tp_spawn):
    """The training cases of each world, by rank."""
    return {w: [rank[0] for rank in spawn["ranks"]] for w, spawn in tp_spawn.items()}


def _check_against(ours, losses, params, tol):
    np.testing.assert_allclose(ours["losses"], losses, **tol)
    assert set(ours["masters"]) == set(params)
    for k, want in params.items():
        np.testing.assert_allclose(ours["masters"][k], want, err_msg=k, **tol)


@pytest.mark.parametrize("world,i", CASE_IDS, ids=[f"w{w}-case{i}" for w, i in CASE_IDS])
def test_tp_training_matches_jax_engine(tp_runs, jax_run, world, i):
    """tp=2 and tp=2 x dp=2, every stage (and MiCS, and two remat
    policies): losses and final masters of the single-device fp64 JAX
    engine; clipping active; every rank the same loss and the same
    gathered weights."""
    ranks = tp_runs[world]
    ours = ranks[0][i]
    assert ours["tp"] == 2 and ours["dp_world"] == world // 2
    _check_against(ours, jax_run["losses"], jax_run["params"], TOL)
    np.testing.assert_allclose(ours["grad_norms"], jax_run["grad_norms"], rtol=1e-5)
    assert min(ours["grad_norms"]) > CLIP, "clipping must be active"
    for other in ranks[1:]:
        assert other[i]["losses"] == ours["losses"]
        for k, v in ours["masters"].items():
            np.testing.assert_array_equal(other[i]["masters"][k], v)


@pytest.mark.parametrize("world,i", CASE_IDS, ids=[f"w{w}-case{i}" for w, i in CASE_IDS])
def test_tp_matches_port_one_process(tp_runs, one_process, world, i):
    """The same run against the port's own unsharded trainer."""
    _check_against(tp_runs[world][0][i], one_process["losses"],
                   one_process["masters"], TOL)


def test_tp_local_masters_are_the_model_major_cut(tp_runs):
    """Stage 3 at tp=2 x dp=2: each rank's fp64 masters are the ZeRO piece
    within its model-axis shard of the whole tree, on a leaf where both
    shard the same dim (``w_gate``'s FFN dim) and on the vocab-parallel
    embedding; norms are whole on every rank."""
    ranks = tp_runs[4]
    stage3 = 3
    for rank in ranks:
        got = rank[stage3]
        t, z = got["axis_model"], got["axis_data"]
        # (leaf, its model-axis dim, the dim the planner gives ZeRO)
        for name, tdim, zdim in (("layers/w_gate", 2, 2), ("embed", 0, 0),
                                 ("layers/wq", 2, 1)):
            full = got["masters"][name]
            tp_shard = np.split(full, 2, axis=tdim)[t]
            want = np.split(tp_shard, 2, axis=zdim)[z]
            np.testing.assert_array_equal(got["local_masters"][name], want, err_msg=name)
        np.testing.assert_array_equal(got["local_masters"]["final_norm_scale"],
                                      np.split(got["masters"]["final_norm_scale"], 2)[z])


def test_tp_dropout_matches_one_process(tp_runs, params_np, batches):
    """Dropout 0.1 at tp=2 x dp=2: the masks are keyed by the data-parallel
    row, so the TP ranks of a replica draw the same masks and the run equals
    the one-process run's."""
    ref = _run_case({"config": _config(0), "model": MODEL,
                     "model_kw": {"dropout": 0.1}}, params_np, batches)
    got = tp_runs[4][0][len(CASES[4])]
    _check_against(got, ref["losses"], ref["masters"], TOL)
    assert got["losses"] != tp_runs[4][0][0]["losses"]   # the masks did something


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
def tp_ckpt(tmp_path_factory):
    params_np = jax.tree_util.tree_map(
        np.asarray, jtf.init_params(jtf.get_config(MODEL), jax.random.PRNGKey(3)))
    batches = make_batches(4, 8, seed=5)
    tmp = tmp_path_factory.mktemp("tpckpt")
    ckpt_dir = str(tmp / "ckpt")
    kw = dict(config=_ckpt_config(), params_np=params_np, batches=batches,
              ckpt_dir=ckpt_dir, model=MODEL, timeout=DEADLINE)
    saved = run_ranks(4, "checkpoint", tmp, mode="save", mesh={"tp": 2, "dp": 2}, **kw)
    resumed = run_ranks(4, "checkpoint", tmp, mode="resume", mesh={"tp": 2, "dp": 2},
                        **kw)
    loaded = run_ranks(4, "checkpoint", tmp, mode="load", mesh={"dp": 4}, **kw)
    return params_np, ckpt_dir, saved, resumed, loaded


def _equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_tp_checkpoint_resume_is_bit_exact(tp_ckpt):
    _, _, saved, resumed, _ = tp_ckpt
    for s, r in zip(saved, resumed):
        assert r["losses"] == s["losses"][2:]
        _equal(r["saved"], s["saved"])
        _equal(r["final"], s["final"])
        assert r["steps"] == s["steps"] == 4


def test_tp_checkpoint_loads_at_other_layouts(tp_ckpt):
    """The tp=2 x dp=2 save loads at tp=1 x dp=4 and in the one-device
    engine, the masters bit for bit."""
    params_np, ckpt_dir, saved, _, loaded = tp_ckpt
    for r in loaded:
        _equal(r["saved"], saved[0]["saved"])
        assert r["steps"] == 2
    cfg = {**_ckpt_config(), "train_batch_size": 4}
    engine, *_ = ds.initialize(model=CausalLM(MODEL, dtype=torch.bfloat16), config=cfg,
                               device="cpu", params=params_from_jax(params_np, "cpu"))
    engine.load_checkpoint(ckpt_dir)
    one = {p: x.numpy() for p, x in tree_flatten_with_path(engine.get_params(fp32=True))}
    _equal(one, saved[0]["saved"])


def test_tp_zero_to_fp32_and_reshard(tp_ckpt, tmp_path):
    """``zero_to_fp32`` assembles the model-major chunks into the whole
    masters; ``reshard_checkpoint`` at mp 2 writes each rank its slices,
    which ``load_mp_shard`` reads back."""
    _, ckpt_dir, saved, _, _ = tp_ckpt
    sd = get_fp32_state_dict_from_zero_checkpoint(ckpt_dir)
    _equal({k: v.numpy() for k, v in sd.items()}, saved[0]["saved"])
    out = tmp_path / "mp2"
    reshard_checkpoint(ckpt_dir, 2, str(out), MODEL)
    whole = {k: torch.from_numpy(v) for k, v in saved[0]["saved"].items()}
    for m in range(2):
        got = load_mp_shard(str(out), m, MODEL)
        want = ttf.shard_params(ttf.get_config(MODEL),
                                _unflatten(whole), m, 2)
        for (p, a), (_, b) in zip(tree_flatten_with_path(got),
                                  tree_flatten_with_path(want)):
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=p)
    # an HF directory is resharded by the inference tool (per-rank
    # safetensors of the checkpoint's own names) and merges back whole
    from deepspeed_tpu_torch.module_inject import load_hf_checkpoint_sharded
    from tests.unit.test_sharded_load import (TINY_LLAMA, _llama_state_dict,
                                              _write_sharded_ckpt)

    (tmp_path / "hf").mkdir()
    hf_dir = _write_sharded_ckpt(tmp_path / "hf", TINY_LLAMA,
                                 _llama_state_dict(TINY_LLAMA), n_shards=2)
    meta = reshard_checkpoint(hf_dir, 2, str(tmp_path / "hf_mp2"), MODEL)
    assert meta.endswith("ds_inference_config.json")
    _, merged = load_hf_checkpoint_sharded(meta, hf_config=TINY_LLAMA, device="cpu")
    _, direct = load_hf_checkpoint_sharded(hf_dir, device="cpu")
    for (p, a), (_, b) in zip(tree_flatten_with_path(merged),
                              tree_flatten_with_path(direct)):
        assert torch.equal(a, b), p


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, x in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = x
    return tree


# ---------------------------------------------------------------------------
# Inference and serving
# ---------------------------------------------------------------------------

SERVE_KW = {"b_slots": 3, "page_size": 8, "max_model_len": 64}
LANES = [{"temperature": 0.9, "top_k": 25, "top_p": 0.95, "seed": 3},
         {"temperature": 1.0, "seed": 7}]
MAX_NEW = 6


def _serve_inputs():
    rs = np.random.RandomState(0)
    tokens = rs.randint(0, 256, (2, 16))
    prompts = rs.randint(1, 256, (2, 5))
    stream = [{"rid": i, "ids": rs.randint(1, 256, rs.randint(3, 12)).tolist(),
               "max_new": int(rs.choice((4, 6))),
               "sampling": ({"temperature": 0.9, "top_k": 25, "top_p": 0.95,
                             "seed": 100 + i} if i % 2 else None)}
              for i in range(6)]
    # every other request's budget expires mid-run
    deadline = [{"rid": 100 + i, "ids": rs.randint(1, 256, 6).tolist(), "max_new": 40,
                 "deadline_s": 0.05 if i % 2 else None} for i in range(4)]
    return tokens, prompts, stream, deadline


@pytest.fixture(scope="module")
def serve_run(tmp_path_factory):
    jmodel = JaxCausalLM(MODEL, dtype=jnp.float32, attn_impl="xla")
    jparams = jmodel.init_fn(jax.random.PRNGKey(4))
    params_np = jax.tree_util.tree_map(np.asarray, jparams)
    tokens, prompts, stream, deadline = _serve_inputs()
    ranks = run_ranks(2, "serve", tmp_path_factory.mktemp("tpserve"), timeout=DEADLINE,
                      model=MODEL, params_np=params_np, tp=2, tokens=tokens,
                      prompts=prompts, max_new=MAX_NEW, stream=stream,
                      deadline_stream=deadline, serve_kw=SERVE_KW, lanes=LANES)
    jeng = deepspeed_tpu.init_inference(model=jmodel, config={"dtype": "float32"},
                                        params=jparams)
    teng = ds.init_inference(CausalLM(MODEL, dtype=torch.float32),
                             config={"dtype": "float32"},
                             params=params_from_jax(params_np, "cpu"), device="cpu")
    return ranks, jeng, teng, (tokens, prompts, stream, deadline)


def test_tp_forward_matches_jax_logits(serve_run):
    """The logits, and the forward's model-axis collectives as the comms
    logger counts them: the embedding's all-reduce, two a layer, one
    all-gather of the logits."""
    ranks, jeng, _, (tokens, *_) = serve_run
    want = np.asarray(jeng(tokens.astype(np.int32)))
    L = jtf.get_config(MODEL).num_layers
    for rank in ranks:
        np.testing.assert_allclose(rank["logits"], want, atol=2e-5, rtol=0)
        got = rank["forward_collectives"]
        assert got["all_reduce"]["model"]["calls"] == 2 * L + 1
        assert got["all_gather"]["model"]["calls"] == 1


def test_tp_generate_token_exact(serve_run):
    """Greedy: the port's unsharded engine and JAX's ``generate``; sampled
    lanes: the port's unsharded engine (per-lane seeds)."""
    ranks, jeng, teng, (_, prompts, _, _) = serve_run
    greedy = teng.generate(prompts, max_new_tokens=MAX_NEW).numpy()
    np.testing.assert_array_equal(
        greedy, np.asarray(jeng.generate(prompts.astype(np.int32),
                                         max_new_tokens=MAX_NEW)))
    sampled = teng.generate(prompts, max_new_tokens=MAX_NEW,
                            sampling=[SamplingParams(**lp) for lp in LANES]).numpy()
    for rank in ranks:
        np.testing.assert_array_equal(rank["greedy"], greedy)
        np.testing.assert_array_equal(rank["sampled"], sampled)


def test_tp_serving_token_exact(serve_run):
    """Every rank's served stream equals the unsharded ``ServingEngine``'s
    and ``generate``'s (greedy and sampled requests)."""
    ranks, _, teng, (_, _, stream, _) = serve_run
    ref = {r.rid: r.output_ids for r in teng.serving(**SERVE_KW).run(_requests(stream))}
    for req in _requests(stream):
        oracle = teng.generate(req.input_ids[None], max_new_tokens=req.max_new_tokens,
                               sampling=req.sampling or SamplingParams()).numpy()
        np.testing.assert_array_equal(ref[req.rid], oracle[0, len(req.input_ids):])
        for rank in ranks:
            ids, reason = rank["served"][req.rid]
            np.testing.assert_array_equal(ids, ref[req.rid], err_msg=str(req.rid))
            assert reason == "length"


def test_tp_serving_pool_and_pages(serve_run):
    """The pool holds each rank's KV heads: per device x tp == total; the
    page invariant holds after each run; the inventory is one decode step
    and one prefill bucket (decode runs eagerly on the CPU)."""
    ranks, _, teng, _ = serve_run
    unsharded = teng.serving(**SERVE_KW).health()
    for rank in ranks:
        h = rank["health"]
        assert h["kv_pool_bytes_per_device"] * 2 == h["kv_pool_bytes_total"]
        assert h["kv_pool_bytes_total"] == unsharded["kv_pool_bytes_total"]
        assert h["mesh_devices"] == 2 and h["mesh_axes"] == {"model": 2}
        assert rank["balanced"] and rank["balanced_after_deadlines"]
        assert rank["inventory"]["decode"] == 1 and rank["inventory"]["captures"] == 0
        assert rank["local_shapes"]["layers/wk"] == (2, 64, 8)      # 1 KV head
        assert rank["local_shapes"]["embed"] == (128, 64)           # half the vocab


def test_tp_serving_ranks_agree_under_deadlines(serve_run):
    """Rank 0's clock decides expiry: both ranks finish the same requests
    the same way, tokens included, and some did expire."""
    ranks, *_ = serve_run
    a, b = ranks[0]["deadline"], ranks[1]["deadline"]
    assert set(a) == set(b)
    for rid in a:
        np.testing.assert_array_equal(a[rid][0], b[rid][0])
        assert a[rid][1] == b[rid][1]
    assert {reason for _, reason in a.values()} >= {"deadline", "length"}


def test_kv_heads_not_divisible_is_refused():
    """tiny has 4 KV heads: a model axis of 8 cannot shard the pool; the
    executor says so before any process group or collective is needed."""
    model = CausalLM("tiny", dtype=torch.float32)
    params = model.init_fn(torch.Generator().manual_seed(0), device="cpu")
    from deepspeed_tpu_torch.inference import ServingEngine

    with pytest.raises(ValueError, match="kv_heads=4"):
        ServingEngine(model, params, mesh=MeshLayout(tp=8), device="cpu", **SERVE_KW)
    with pytest.raises(RuntimeError, match="process group"):
        ServingEngine(model, params, mesh=MeshLayout(tp=2), device="cpu", **SERVE_KW)


# ---------------------------------------------------------------------------
# Layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["tiny", "tiny-gpt2", "tiny-gqa", "llama2-70b",
                                  "gpt2-125m", "bloom-7b"])
def test_param_specs_match_jax(name):
    theirs = jtf.param_specs(jtf.get_config(name))
    ours = ttf.param_specs(ttf.get_config(name))
    flat = jax.tree_util.tree_flatten_with_path(
        theirs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0]
    paths = {"/".join(str(getattr(k, "key", k)) for k in p): tuple(s) for p, s in flat}
    assert paths == spec_paths(ours)


@pytest.mark.parametrize("name,n", [("tiny", 2), ("tiny", 4), ("tiny-gqa", 2),
                                    ("tiny-gpt2", 2)])
def test_sharded_init_equals_slices(name, n):
    """``init_params(tp=(i, n))`` draws what ``shard_params`` cuts from the
    whole init of the same seed, leaf for leaf, for the default init and
    for the layer-streamed one (``streamed=True``, whose values differ)."""
    model = CausalLM(name)
    whole = model.init_fn(torch.Generator().manual_seed(5), device="cpu")
    streamed = model.init_fn(torch.Generator().manual_seed(5), device="cpu", tp=(0, 1),
                             streamed=True)
    assert not torch.equal(whole["layers"]["wq"], streamed["layers"]["wq"])
    for full, kw in ((whole, {}), (streamed, {"streamed": True})):
        for i in range(n):
            got = model.init_fn(torch.Generator().manual_seed(5), device="cpu",
                                tp=(i, n), **kw)
            want = model.shard_params(full, i, n)
            for (p, a), (_, b) in zip(tree_flatten_with_path(got),
                                      tree_flatten_with_path(want)):
                assert torch.equal(a, b), p
            # place_params recognises a tree of shards by its shapes
            assert place_params(model, got, MeshLayout(tp=n)) is got


def test_seed_names_the_same_weights_at_tp2(tp_runs):
    """No ``params=``: the tp=2 engine's masters, gathered, are bit-equal to
    the one-process engine's from the same seed (each rank draws the
    default init leaf by leaf and keeps its shard)."""
    one, *_ = ds.initialize(model=CausalLM(MODEL, dtype=torch.float64), config=_config(0),
                            device="cpu")
    want = dict(tree_flatten_with_path(one.get_params()))
    for rank in tp_runs[2]:
        got = rank[len(CASES[2])]["init_masters"]
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)


# ---------------------------------------------------------------------------
# Uneven shards
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def uneven_jax():
    """The single-device fp64 JAX engine on each uneven configuration."""
    out = {}
    jax.config.update("jax_enable_x64", True)
    try:
        for name, (model, kw, _, stage) in UNEVEN.items():
            jmesh.reset_mesh()
            mesh = jmesh.initialize_mesh(jmesh.MeshLayout(dp=1), devices=jax.devices()[:1])
            jm = JaxCausalLM(dataclasses.replace(jtf.get_config(model, **kw),
                                                 dtype=jnp.float64))
            eng, *_ = deepspeed_tpu.initialize(
                model=jm, config=_config(stage),
                params=jax.tree_util.tree_map(jnp.asarray, _uneven_params(name)),
                mesh=mesh)
            losses = [float(eng.train_batch(batch={k: v.astype(np.int32)
                                                   for k, v in b.items()}))
                      for b in _uneven_batches(name)]
            out[name] = {"losses": losses, "params": _flat_np(eng.get_params())}
    finally:
        jax.config.update("jax_enable_x64", False)
        jmesh.reset_mesh()
    return out


def _uneven_rank_results(tp_spawn, name):
    n = UNEVEN[name][2]
    spawn = tp_spawn[n]
    i = spawn["n_even"] + spawn["uneven"].index(name)
    return [rank[0][i] for rank in spawn["ranks"]]


@pytest.mark.parametrize("name", UNEVEN_IDS)
def test_uneven_tp_training_matches_jax(tp_spawn, uneven_jax, name):
    """Losses and final masters (gathered, padding cut) of the single-device
    fp64 JAX engine at 5e-6, on every rank."""
    for got in _uneven_rank_results(tp_spawn, name):
        assert got["tp"] == UNEVEN[name][2]
        _check_against(got, uneven_jax[name]["losses"], uneven_jax[name]["params"], TOL)


@pytest.mark.parametrize("name", UNEVEN_IDS)
def test_uneven_pads_stay_zero(tp_spawn, name):
    """After the steps, every padded row of each rank's model-axis shards is
    exactly 0 in the masters (weight decay included) and, at stage 0, in
    both Adam moments; the last rank holds pads."""
    model, kw, n, stage = UNEVEN[name]
    cfg = ttf.get_config(model, **kw)
    specs = spec_paths(ttf.param_specs(cfg))
    units = spec_paths(ttf.tp_units(cfg))
    whole = dict(tree_flatten_with_path(ttf.init_params(cfg, torch.Generator(),
                                                        device="meta")))
    padded = 0
    for got in _uneven_rank_results(tp_spawn, name):
        r = got["axis_model"]
        trees = [got["tp_shards"]] + ([got["moments"]["mu"], got["moments"]["nu"]]
                                      if stage == 0 else [])
        for path, spec in specs.items():
            d = spec_dim(spec)
            if d is None:
                continue
            T = whole[path].shape[d]
            local = got["tp_shards"][path].shape[d]
            assert local == padded_extent(T, n, units[path]) // n, path
            live = max(min(T - r * local, local), 0)
            for tree in trees:
                pad = np.take(tree[path], np.arange(live, local), axis=d)
                assert not pad.any(), (path, r)
                padded += pad.size
    assert padded > 0, "no rank held a padded row"


@pytest.mark.parametrize("name", UNEVEN_IDS)
def test_uneven_generate_matches_jax(tp_spawn, name):
    """fp32 ``forward`` logits (the padded vocabulary columns cut) against
    JAX's single-device ``init_inference`` at atol 2e-5, and greedy
    ``generate`` token for token, on every rank."""
    model, kw, n, _ = UNEVEN[name]
    spawn = tp_spawn[n]
    j = spawn["uneven"].index(name)
    jm = JaxCausalLM(model, dtype=jnp.float32, attn_impl="xla", **kw)
    jparams = jax.tree_util.tree_map(jnp.asarray, _uneven_params(name))
    jeng = deepspeed_tpu.init_inference(model=jm, config={"dtype": "float32"},
                                        params=jparams)
    tokens, prompts, *_ = _serve_inputs()
    want = np.asarray(jeng(tokens.astype(np.int32)))
    greedy = np.asarray(jeng.generate(prompts.astype(np.int32), max_new_tokens=MAX_NEW))
    for rank in spawn["ranks"]:
        got = rank[1][j]
        assert got["logits"].shape == want.shape
        np.testing.assert_allclose(got["logits"], want, atol=2e-5, rtol=0)
        np.testing.assert_array_equal(got["greedy"], greedy)


def test_uneven_checkpoint_carries_true_shapes(tp_spawn, tmp_path):
    """A stage-3 save at tp=4 with llama-740m's 14 heads (padded to 16):
    the files hold the true shapes, a one-device engine loads the saved
    masters bit for bit, ``zero_to_fp32`` gives them whole, and
    ``reshard_checkpoint`` writes each rank its true rows, which
    ``load_mp_shard`` pads back to ``shard_params``'s shard."""
    model, kw, n, _ = UNEVEN["heads14"]
    spawn = tp_spawn[4]
    saved = spawn["ranks"][0][2]["saved"]
    ckpt_dir = spawn["ckpt_dir"]
    cfg = ttf.get_config(model, **kw)
    whole = dict(tree_flatten_with_path(ttf.init_params(cfg, torch.Generator(),
                                                        device="meta")))
    assert {k: v.shape for k, v in saved.items()} == {k: tuple(v.shape)
                                                      for k, v in whole.items()}
    engine, *_ = ds.initialize(model=CausalLM(model, dtype=torch.bfloat16, **kw),
                               config={**_ckpt_config(), "train_batch_size": 2},
                               device="cpu",
                               params=params_from_jax(_uneven_params("heads14"), "cpu"))
    engine.load_checkpoint(ckpt_dir)
    _equal({p: x.numpy() for p, x in tree_flatten_with_path(engine.get_params(fp32=True))},
           saved)
    sd = get_fp32_state_dict_from_zero_checkpoint(ckpt_dir)
    _equal({k: v.numpy() for k, v in sd.items()}, saved)
    out = tmp_path / "mp4"
    cm = CausalLM(model, **kw)
    reshard_checkpoint(ckpt_dir, n, str(out), cm)
    full = _unflatten({k: torch.from_numpy(v) for k, v in saved.items()})
    for m in range(n):
        raw = torch.load(out / f"mp_rank_{m:02d}_model_states.pt", weights_only=True)
        assert raw["layers/wq"].shape[-1] == (4 if m < 3 else 2) * 4   # heads x hd
        got = load_mp_shard(str(out), m, cm)
        want = cm.shard_params(full, m, n)
        for (p, a), (_, b) in zip(tree_flatten_with_path(got),
                                  tree_flatten_with_path(want)):
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=p)


def test_uneven_layout_helpers():
    """``shard_params`` pads each sharded dim to ``n`` whole units at its
    end; the true pieces (``true_piece``) put back together are the
    leaf; the KV heads a model axis splits from their query heads are
    gathered."""
    cfg = ttf.get_config("llama-740m", **UNEVEN["heads14"][1])
    p = ttf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    shards = [ttf.shard_params(cfg, p, i, 4) for i in range(4)]
    assert shards[0]["layers"]["wq"].shape == (2, 56, 16)     # 4 heads of 4
    assert not shards[3]["layers"]["wq"][..., 8:].any()       # 2 pad heads
    assert not shards[3]["layers"]["wo"][:, 8:].any()
    spec = ttf.param_specs(cfg)["layers"]["wq"]
    true = [true_piece(sh["layers"]["wq"], spec, i, 4, 56) for i, sh in enumerate(shards)]
    assert [t.shape[-1] for t in true] == [16, 16, 16, 8]
    assert torch.equal(torch.cat(true, -1), p["layers"]["wq"])
    assert ttf.kv_gathered(ttf.get_config("tiny-gqa"), 4)
    assert not ttf.kv_gathered(ttf.get_config("tiny-gqa"), 2)
    assert ttf.local_heads(ttf.get_config("tiny-gqa"), 4) == (2, 2)
    assert ttf.local_heads(cfg, 4) == (4, 4)


# ---------------------------------------------------------------------------
# Generic models, the serving mesh over the first ranks, the teardown
# ---------------------------------------------------------------------------

def _generic(tp_spawn):
    return [rank[2] for rank in tp_spawn[2]["ranks"]]


def test_generic_training_contract(tp_spawn):
    """JAX's ``test_tensor_parallel_training``: at tp=2 ``linear_0``'s kernel
    is column-parallel, its local shape ``[.., n/2]`` (``linear_1`` row-
    parallel), and the loss falls over 5 steps, every rank the same."""
    ranks = _generic(tp_spawn)
    for got in ranks:
        assert got["local_kernel"] == (HID, HID // 2)
        assert got["local_row"] == (HID // 2, HID)
        assert got["losses"][-1] < got["losses"][0], got["losses"]
        assert got["losses"] == ranks[0]["losses"]


def test_generic_training_matches_one_process(tp_spawn):
    """tp=2 under DTensor against the port's own one-process run of the
    same seed and batches, losses and gathered masters at fp64 1e-5 (JAX's
    ``test_tp_matches_pure_dp`` is skipped for CPU drift)."""
    cfg = {"train_batch_size": GENERIC_ROWS, "steps_per_print": 10 ** 9,
           "optimizer": {"type": "adamw", "params": {"lr": 1e-2}}}
    eng, *_ = ds.initialize(model=SimpleTPModel(HID), config=cfg, device="cpu")
    losses = [float(eng.train_batch(batch=simple_batch(GENERIC_ROWS, HID, s)))
              for s in range(GENERIC_STEPS)]
    want = dict(tree_flatten_with_path(eng.get_params()))
    for got in _generic(tp_spawn):
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5, atol=1e-5)
        for k, v in want.items():
            np.testing.assert_allclose(got["masters"][k], v.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=k)


def test_generic_forward_matches_single(tp_spawn):
    """JAX's ``test_tp_forward_matches_single``: a bare ``apply_fn`` at
    tp_size 2 (auto-TP: each weight's largest dim) within rtol 1e-5 / atol
    1e-6 of one device; a flash call on DTensors is refused by name."""
    one = ds.init_inference(apply_fn=tiny_lm_apply, params=tiny_lm_params(),
                            config={"dtype": "float32"}, device="cpu")
    want = one(np.array([[1, 2, 3]])).numpy()
    for got in _generic(tp_spawn):
        np.testing.assert_allclose(got["logits"], want, rtol=1e-5, atol=1e-6)
        assert got["lm_local"] == {"embed": (16, 16), "out": (16, 16)}
        assert "local_map" in got["flash_dtensor"]


def test_serving_mesh_over_the_first_ranks(tp_spawn, params_np):
    """``initialize_serving_mesh(n_devices=1)`` at 2 ranks: rank 0 serves on
    a mesh of one, token-exact with the unsharded engine; rank 1's handle
    is refused by ``init_inference(mesh=)`` naming the rank."""
    teng = ds.init_inference(CausalLM(MODEL, dtype=torch.float32),
                             config={"dtype": "float32"},
                             params=params_from_jax(params_np, "cpu"), device="cpu")
    want = teng.generate(_serve_inputs()[1], max_new_tokens=MAX_NEW).numpy()
    r0, r1 = (rank[3] for rank in tp_spawn[2]["ranks"])
    assert not r0["outside"] and r0["mesh_size"] == 1
    np.testing.assert_array_equal(r0["greedy"], want)
    assert r1["outside"] and "rank 1 is outside the serving mesh" in r1["error"]


def test_teardown_closes_captured_graphs():
    """``comm.destroy_process_group()`` first closes every executor its
    capture registered (weakly): the graph's ``reset()`` runs once and the
    registry empties; ``MeshExecutor.close()`` resets its graph itself."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.comm import comm as comm_mod
    from deepspeed_tpu_torch.inference.execution import MeshExecutor

    class StubGraph:
        resets = 0

        def reset(self):
            StubGraph.resets += 1

    model = CausalLM(MODEL, dtype=torch.float32)
    params = model.init_fn(torch.Generator().manual_seed(0), device="cpu")
    ex = MeshExecutor(model, params, num_pages=4, page_size=8, b_slots=1,
                      pages_per_slot=2, device="cpu")
    ex._graph = StubGraph()
    comm.register_capture(ex)
    assert list(comm_mod._CAPTURES) == [ex]
    comm.destroy_process_group()
    assert StubGraph.resets == 1 and ex._graph is None and ex.pools == ()
    assert not list(comm_mod._CAPTURES)
    ex.close()                     # a second close has nothing to reset
    assert StubGraph.resets == 1
