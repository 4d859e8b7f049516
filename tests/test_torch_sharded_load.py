"""The port's streaming checkpoint loader
(``deepspeed_tpu_torch.module_inject.sharded_load``) against the JAX
package's dense conversion, on safetensors files written by
``safetensors.numpy`` as ``tests/unit/test_sharded_load.py`` writes them.

Streamed trees must equal the JAX package's ``hf_state_dict_to_params`` bit
for bit for every family and every layout (index-sharded and single
safetensors, ``.bin`` with and without an index, a DeepSpeed json of
mp_size 2); the port's own safetensors reader must equal the
``safetensors`` package's; a directory must load with ``transformers``,
``safetensors`` and ``ml_dtypes`` blocked and within the JAX test's host
memory budget; on two gloo ranks each rank's tree must be
``shard_params`` of the whole tree (uneven shards padded) and the logits
the single process's.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from deepspeed_tpu.module_inject import hf_state_dict_to_params as jax_convert
from deepspeed_tpu.module_inject import load_hf_checkpoint_sharded as jax_sharded
from deepspeed_tpu.module_inject.load import config_from_hf as jax_config_from_hf
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.models.transformer import shard_params
from deepspeed_tpu_torch.module_inject import (config_from_hf, detect_arch,
                                               load_hf_checkpoint_sharded)
from deepspeed_tpu_torch.module_inject.policies import POLICIES
from deepspeed_tpu_torch.module_inject.sharded_load import (SafetensorsFile,
                                                            make_classifier)
from deepspeed_tpu_torch.utils.tree import tree_flatten_with_path
from tests._torch_ranks import run_ranks
from tests.unit.test_sharded_load import (TINY_LLAMA, _llama_state_dict, _tiny_hf,
                                          _write_sharded_ckpt)

safetensors_numpy = pytest.importorskip("safetensors.numpy")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tree(sd, cfg_dict):
    """The JAX package's dense conversion, as the port's tree (fp32, cpu)."""
    tree = jax_convert(sd, jax_config_from_hf(cfg_dict), detect_arch(cfg_dict))
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def _assert_equal(got, want, tag=""):
    g, w = dict(tree_flatten_with_path(got)), dict(tree_flatten_with_path(want))
    assert sorted(g) == sorted(w), tag
    for path in g:
        assert g[path].dtype == w[path].dtype, (tag, path)
        assert g[path].is_contiguous(), (tag, path)
        assert torch.equal(g[path], w[path]), (tag, path)


@pytest.fixture()
def tiny_ckpt(tmp_path):
    sd = _llama_state_dict(TINY_LLAMA)
    return _write_sharded_ckpt(tmp_path, TINY_LLAMA, sd, n_shards=2), sd


def test_sharded_load_matches_dense(tiny_ckpt):
    path, sd = tiny_ckpt
    cfg, params = load_hf_checkpoint_sharded(path, device="cpu")
    assert cfg == config_from_hf(TINY_LLAMA)
    _assert_equal(params, _jax_tree(sd, TINY_LLAMA))
    # and the JAX package's own streaming loader reads the same tree
    _, jparams = jax_sharded(path)
    _assert_equal(params, params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                          device="cpu"))


@pytest.mark.parametrize("arch", ["gpt2", "gpt_neox", "bloom", "gptj", "opt",
                                  "gpt_neo", "bert", "distilbert", "clip"])
def test_policy_matrix_sharded_equals_dense(arch, tmp_path):
    hf_cfg, sd = _tiny_hf(arch)
    cfg_dict = hf_cfg.to_dict()
    path = _write_sharded_ckpt(tmp_path, cfg_dict, sd, n_shards=3)
    _, streamed = load_hf_checkpoint_sharded(path, device="cpu")
    _assert_equal(streamed, _jax_tree(sd, cfg_dict), arch)


def test_reader_equals_safetensors(tmp_path):
    import ml_dtypes
    from safetensors import safe_open

    rs = np.random.default_rng(0)
    arrays = {"f32": rs.standard_normal((3, 5)).astype(np.float32),
              "f16": rs.standard_normal((7,)).astype(np.float16),
              "bf16": rs.standard_normal((2, 3, 4)).astype(ml_dtypes.bfloat16),
              "bf16_odd": rs.standard_normal((5,)).astype(ml_dtypes.bfloat16),
              "i64": rs.integers(-9, 9, (4,)).astype(np.int64),
              "i32": rs.integers(-9, 9, (3, 1)).astype(np.int32),
              "empty": np.zeros((0, 4), np.float32)}
    path = str(tmp_path / "t.safetensors")
    safetensors_numpy.save_file(arrays, path)
    ours = SafetensorsFile(path)
    assert sorted(ours.keys()) == sorted(arrays)
    with safe_open(path, framework="pt") as ref:
        for name in arrays:
            want, got = ref.get_tensor(name), ours.get(name)
            assert got.dtype == want.dtype and got.shape == want.shape, name
            assert torch.equal(got, want), name


def test_bin_and_single_file_layouts(tmp_path):
    sd = _llama_state_dict(TINY_LLAMA, seed=4)
    want = _jax_tree(sd, TINY_LLAMA)
    tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
    names = sorted(sd)
    layouts = {"single_safetensors": lambda d: safetensors_numpy.save_file(
                   sd, str(d / "model.safetensors")),
               "single_bin": lambda d: torch.save(tsd, d / "pytorch_model.bin")}

    def bin_index(d):
        half = {0: names[::2], 1: names[1::2]}
        weight_map = {}
        for i, part in half.items():
            fname = f"pytorch_model-{i + 1:05d}-of-00002.bin"
            torch.save({n: tsd[n] for n in part}, d / fname)
            weight_map.update({n: fname for n in part})
        (d / "pytorch_model.bin.index.json").write_text(
            json.dumps({"metadata": {}, "weight_map": weight_map}))

    layouts["bin_index"] = bin_index
    for name, write in layouts.items():
        d = tmp_path / name
        d.mkdir()
        write(d)
        (d / "config.json").write_text(json.dumps(TINY_LLAMA))
        _, params = load_hf_checkpoint_sharded(str(d), device="cpu")
        _assert_equal(params, want, name)
    with pytest.raises(FileNotFoundError, match="no recognized weight files"):
        load_hf_checkpoint_sharded(str(tmp_path), hf_config=TINY_LLAMA, device="cpu")


def test_mp2_checkpoint_json_merges(tiny_ckpt, tmp_path):
    """A DeepSpeed json with mp_size 2, written by the port's reshard tool
    and by the JAX package's, merges back to the whole tree; and
    ``init_inference(<dir>, config={"checkpoint": json})`` reads it."""
    import deepspeed_tpu_torch
    from deepspeed_tpu.checkpoint.reshard import reshard_inference_checkpoint as jax_reshard
    from deepspeed_tpu_torch.checkpoint import reshard_inference_checkpoint

    path, sd = tiny_ckpt
    want = _jax_tree(sd, TINY_LLAMA)
    ours = reshard_inference_checkpoint(path, 2, str(tmp_path / "mp2"))
    meta = json.loads(open(ours).read())
    shard0 = SafetensorsFile(str(tmp_path / "mp2" / meta["checkpoints"][0]))
    assert tuple(shard0.get("model.embed_tokens.weight").shape) == (
        TINY_LLAMA["vocab_size"] // 2, TINY_LLAMA["hidden_size"])
    assert tuple(shard0.get("model.layers.0.self_attn.q_proj.weight").shape)[0] == (
        TINY_LLAMA["hidden_size"] // 2)    # [out, in]: out is split
    theirs = jax_reshard(path, 2, str(tmp_path / "jax_mp2"))
    for meta_path in (ours, theirs):
        _, params = load_hf_checkpoint_sharded(meta_path, hf_config=TINY_LLAMA,
                                               device="cpu")
        _assert_equal(params, want, meta_path)
    eng = deepspeed_tpu_torch.init_inference(
        path, config={"dtype": "float32", "checkpoint": ours}, device="cpu")
    _assert_equal(eng.params, want, "init_inference(checkpoint=)")


def test_reshard_roundtrip_mp2_to_mp4_to_mp1(tiny_ckpt, tmp_path):
    """From the HF source through the port's ``reshard_checkpoint`` (which
    takes HF sources now) and back: every tensor as it was."""
    from deepspeed_tpu_torch.checkpoint import (reshard_checkpoint,
                                                reshard_inference_checkpoint)

    path, sd = tiny_ckpt
    m2 = reshard_checkpoint(path, 2, str(tmp_path / "mp2"))
    m4 = reshard_inference_checkpoint(m2, 4, str(tmp_path / "mp4"), model_dir=path)
    m1 = reshard_inference_checkpoint(m4, 1, str(tmp_path / "mp1"), model_dir=path)
    merged = safetensors_numpy.load_file(
        str(tmp_path / "mp1" / json.loads(open(m1).read())["checkpoints"][0]))
    assert sorted(merged) == sorted(sd)
    for name in sd:
        np.testing.assert_array_equal(merged[name], sd[name], name)


def test_classifier_strips_export_prefix():
    bert = {"model_type": "bert", "vocab_size": 64, "hidden_size": 32,
            "intermediate_size": 64, "num_hidden_layers": 2,
            "num_attention_heads": 4, "max_position_embeddings": 32,
            "type_vocab_size": 2, "layer_norm_eps": 1e-12, "hidden_act": "gelu"}
    classify = make_classifier(POLICIES["bert"], config_from_hf(bert))
    for name in ("encoder.layer.0.attention.self.query.weight",
                 "bert.encoder.layer.0.attention.self.query.weight"):
        assert classify(name) == ("split", 0), name
    assert classify("bert.embeddings.LayerNorm.weight")[0] == "replicated"
    assert classify("bert.encoder.layer.1.output.dense.weight") == ("split", 1)


_BLOCKED = r"""
import json, sys
for mod in ("transformers", "safetensors", "ml_dtypes", "jax"):
    sys.modules[mod] = None
sys.path.insert(0, {root!r})
import torch
import deepspeed_tpu_torch as ds
eng = ds.init_inference({path!r}, config={{"dtype": "bfloat16"}}, device="cpu")
logits = eng.forward(torch.zeros((1, 8), dtype=torch.long))
print(json.dumps({{"shape": list(logits.shape), "finite": bool(torch.isfinite(logits).all()),
                  "embed": str(eng.params["embed"].dtype)}}))
"""


def test_directory_loads_with_optional_packages_blocked(tiny_ckpt):
    path, _ = tiny_ckpt
    proc = subprocess.run([sys.executable, "-c", _BLOCKED.format(root=ROOT, path=path)],
                          capture_output=True, text=True, timeout=120,
                          env={k: v for k, v in os.environ.items()
                               if k != "DS_ACCELERATOR"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"shape": [1, 8, TINY_LLAMA["vocab_size"]], "finite": True,
                   "embed": "torch.bfloat16"}


_RSS = r"""
import json, sys, threading, time
sys.path.insert(0, {root!r})
import torch
from deepspeed_tpu_torch.module_inject import load_hf_checkpoint_sharded
from deepspeed_tpu_torch.utils.tree import tree_leaves

def anon():
    with open("/proc/self/status") as f:
        return next(int(l.split()[1]) * 1024 for l in f if l.startswith("RssAnon:"))

base, peak, done = anon(), [0], []
def sample():
    while not done:
        peak[0] = max(peak[0], anon())
        time.sleep(0.001)
t = threading.Thread(target=sample)
t.start()
cfg, params = load_hf_checkpoint_sharded({path!r}, device="cpu")
done.append(1)
t.join()
n = sum(x.numel() * x.element_size() for x in tree_leaves(params))
print(json.dumps({{"model_bytes": n, "anon_growth": max(peak[0], anon()) - base}}))
"""


def test_streaming_host_anon_memory_within_budget(tmp_path):
    """The JAX test's bar (``tests/unit/test_sharded_load.py``: the tree,
    which lives in host memory on the CPU, plus a streaming margin, below a
    second copy), on host anonymous memory: mmap'd shard pages are file
    pages and do not count."""
    big = dict(TINY_LLAMA, hidden_size=256, intermediate_size=1024,
               num_hidden_layers=8, vocab_size=8192, num_attention_heads=8,
               num_key_value_heads=8)
    sd = _llama_state_dict(big, seed=3)
    path = _write_sharded_ckpt(tmp_path, big, sd, n_shards=4)
    model_bytes = sum(v.nbytes for v in sd.values())
    assert model_bytes > 40e6
    proc = subprocess.run([sys.executable, "-c", _RSS.format(root=ROOT, path=path)],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["model_bytes"] == model_bytes
    assert out["anon_growth"] < out["model_bytes"] * 1.35 + 450e6, out


def test_tp2_ranks_load_their_shards(tmp_path):
    """``init_inference(<dir>, mesh=initialize_serving_mesh(tp=2))`` on two
    gloo ranks: each rank's tree is ``shard_params`` of the whole tree (a
    vocabulary of 127 and an FFN of 65 pad uneven shards), and the logits
    and greedy tokens equal one process's."""
    import deepspeed_tpu_torch

    cfg_dict = dict(TINY_LLAMA, vocab_size=127, intermediate_size=65)
    sd = _llama_state_dict(cfg_dict, seed=5)
    path = _write_sharded_ckpt(tmp_path, cfg_dict, sd, n_shards=2)
    whole = _jax_tree(sd, cfg_dict)
    rs = np.random.default_rng(2)
    tokens = rs.integers(0, 127, (2, 12))
    prompts = rs.integers(0, 127, (2, 5)).astype(np.int32)
    one = deepspeed_tpu_torch.init_inference(path, config={"dtype": "float32"},
                                             device="cpu")
    want_logits = one.forward(torch.as_tensor(tokens)).numpy()
    want_greedy = one.generate(prompts, max_new_tokens=4).numpy()
    outs = run_ranks(2, "hf_load", tmp_path, timeout=90, path=path, tp=2,
                     tokens=tokens, prompts=prompts, max_new=4)
    cfg = config_from_hf(cfg_dict)
    for rank, out in enumerate(outs):
        want = dict(tree_flatten_with_path(shard_params(cfg, whole, rank, 2)))
        assert sorted(out["params"]) == sorted(want)
        for p, x in out["params"].items():
            assert torch.equal(x, want[p]), (rank, p)
        np.testing.assert_allclose(out["logits"], want_logits, atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(out["greedy"], want_greedy)
