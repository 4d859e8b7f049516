"""The one-device trainer on the card: the remat policies' kernel launches
and gradients, forward/backward/step against train_batch, and bit-exact
resume from a checkpoint, at a small size (2 layers, two 128-wide heads,
S=256, bf16 over fp32 masters, the flash kernels forced with
``attn_impl="pallas"``).

Every comparison is bit for bit (``torch.equal``): the same kernels run on
the same inputs whichever policy or loop runs them, and K2/K3 use no
atomics.  Marked ``gpu``: they skip on a host without a CUDA card.  This
file imports no jax, so it runs on the GPU machine on its own:

    python -m pytest --noconftest -m gpu tests/test_torch_training_gpu.py -q
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as ds
from deepspeed_tpu_torch.models import CausalLM
from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
from deepspeed_tpu_torch.utils.tree import tree_leaves

S, LAYERS = 256, 2
MODEL = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
             num_layers=LAYERS, num_heads=2, max_seq_len=S, remat=True,
             attn_impl="pallas")
CONFIG = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
          "optimizer": {"type": "adamw",
                        "params": {"lr": 1e-3, "weight_decay": 0.1}},
          "scheduler": {"type": "WarmupLR",
                        "params": {"warmup_max_lr": 1e-3, "warmup_num_steps": 4}},
          "bf16": {"enabled": True}, "steps_per_print": 10 ** 9}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run `python -m pytest --noconftest "
                    "-m gpu tests/test_torch_training_gpu.py` on the GPU machine")
    return torch.device("cuda")


def _engine(policy="nothing_saveable", config=CONFIG, dropout=0.1):
    kw = {k: v for k, v in MODEL.items() if k != "attn_impl"}
    model = CausalLM("tiny", attn_impl=MODEL["attn_impl"], remat_policy=policy,
                     dropout=dropout, dtype=torch.bfloat16, **kw)
    engine, *_ = ds.initialize(model=model, config=config)
    return engine


def _batches(n, seed=0):
    rs = np.random.RandomState(seed)
    return [{"input_ids": rs.randint(0, MODEL["vocab_size"], (4, S))}
            for _ in range(n)]


def _counts():
    return (fa.flash_attention.launches, fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches)


@pytest.mark.gpu
@pytest.mark.parametrize("policy,k1", [("nothing_saveable", 2), ("save_attn", 2),
                                       ("save_qkv", 1), ("save_matmuls", 1),
                                       ("dots_saveable", 2)])
def test_policy_launches_and_grads(cuda, policy, k1):
    """Per micro-batch: K1 ``k1`` times a layer, K2 and K3 once; one step's
    losses and parameters equal ``nothing_saveable``'s."""
    batch = _batches(1)[0]
    runs = {}
    for name in ("nothing_saveable", policy):
        engine = _engine(name)
        before = _counts()
        loss = engine.train_batch(batch=batch)
        torch.cuda.synchronize()
        runs[name] = (loss, tree_leaves(engine.state.master_params),
                      tuple(a - b for a, b in zip(_counts(), before)))
    gas = CONFIG["gradient_accumulation_steps"]
    assert runs[policy][2] == (k1 * LAYERS * gas, LAYERS * gas, LAYERS * gas)
    assert torch.equal(runs[policy][0], runs["nothing_saveable"][0])
    for a, b in zip(runs[policy][1], runs["nothing_saveable"][1]):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_forward_backward_step_equals_train_batch(cuda):
    a, b = _engine("save_qkv"), _engine("save_qkv")
    for batch in _batches(2, seed=1):
        la = a.train_batch(batch=batch)
        for i in range(2):
            b.backward(b.forward({"input_ids": batch["input_ids"][2 * i:2 * i + 2]}))
        assert torch.equal(b.step()["loss"], la)
    for x, y in zip(tree_leaves(a.state.master_params),
                    tree_leaves(b.state.master_params)):
        assert torch.equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("async_save", [False, True])
def test_resume_is_bit_exact(cuda, tmp_path, async_save):
    config = {**CONFIG, "checkpoint": {"async_save": async_save}}
    batches = _batches(4, seed=2)
    a = _engine("save_qkv", config)
    for batch in batches[:2]:
        a.train_batch(batch=batch)
    a.save_checkpoint(str(tmp_path))
    tail_a = [a.train_batch(batch=batch) for batch in batches[2:]]
    a.wait_for_checkpoint()
    b = _engine("save_qkv", {**config, "seed": 5})
    b.load_checkpoint(str(tmp_path))
    tail_b = [b.train_batch(batch=batch) for batch in batches[2:]]
    for x, y in zip(tail_a, tail_b):
        assert torch.equal(x, y)
    for x, y in zip(tree_leaves(a.state.master_params) + tree_leaves(a.state.params),
                    tree_leaves(b.state.master_params) + tree_leaves(b.state.params)):
        assert torch.equal(x, y)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.mark.gpu
def test_launched_child_loads_the_built_kernels(cuda, tmp_path):
    """``python -m deepspeed_tpu_torch.launcher --num_gpus 1`` starts a
    training process that trains through K1-K3 from the libraries this
    process built (it builds none itself and never falls back to the plain
    version)."""
    for b in fa.builders():
        b.build()
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"mode": "kernels", "out": str(tmp_path), "model": MODEL,
                                "config": CONFIG}))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = Path(__file__).resolve().parents[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("DS_ACCELERATOR", "RANK", "LOCAL_RANK", "WORLD_SIZE",
                        "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = str(root)
    res = subprocess.run([sys.executable, "-m", "deepspeed_tpu_torch.launcher", "-H",
                          str(tmp_path / "no_hostfile"), "--num_gpus", "1", "--master_port",
                          str(port), "--module", "tests._torch_elastic_child", str(spec)],
                         cwd=str(root), env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    rec = json.loads((tmp_path / "kernels0.json").read_text())
    gas = CONFIG["gradient_accumulation_steps"]
    assert rec["launches"] == [2 * LAYERS * gas, LAYERS * gas, LAYERS * gas]
    assert np.isfinite(rec["loss"])
    for b in fa.builders():
        lib = rec["libraries"][b.name]
        assert lib["loaded"] and lib["built_here_s"] == 0.0
        assert lib["path"] == str(b.library_path())
