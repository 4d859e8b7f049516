"""Import rules of the PyTorch/CUDA port: ``deepspeed_tpu_torch`` and
``chip_smoke.py`` never load ``jax``, ``pydantic`` or ``deepspeed_tpu``
(the card's machine has neither jax nor pydantic), and entry points never
fall back to the CPU without being asked."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "deepspeed_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "pydantic", "deepspeed_tpu")


def _clean_env():
    env = {k: v for k, v in os.environ.items() if k != "DS_ACCELERATOR"}
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_import_loads_no_jax_pydantic_or_reference():
    code = ("import sys, deepspeed_tpu_torch, deepspeed_tpu_torch.models, "
            "deepspeed_tpu_torch.inference, deepspeed_tpu_torch.models.convert, "
            "deepspeed_tpu_torch.inference.serving, "
            "deepspeed_tpu_torch.inference.execution, "
            "deepspeed_tpu_torch.inference.prefix_cache, "
            "deepspeed_tpu_torch.ops.kernels.flash_attention, "
            "deepspeed_tpu_torch.ops.kernels.decode_attention, "
            "deepspeed_tpu_torch.ops.ring_attention, "
            "deepspeed_tpu_torch.parallel.tensor_parallel, "
            "deepspeed_tpu_torch.checkpoint.reshard, "
            "deepspeed_tpu_torch.ops.sparse_attention, "
            "deepspeed_tpu_torch.ops.sparse_attention.sparsity_config, "
            "deepspeed_tpu_torch.ops.transformer, "
            "deepspeed_tpu_torch.runtime.engine, deepspeed_tpu_torch.runtime.config, "
            "deepspeed_tpu_torch.runtime.optimizer, "
            "deepspeed_tpu_torch.runtime.lr_schedules, "
            "deepspeed_tpu_torch.runtime.fp16.loss_scaler, "
            "deepspeed_tpu_torch.runtime.dataloader, deepspeed_tpu_torch.utils.timer, "
            "deepspeed_tpu_torch.utils.memory, "
            "deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine, "
            "deepspeed_tpu_torch.runtime.checkpoint_engine.dcp_engine, "
            "deepspeed_tpu_torch.runtime.checkpoint_engine.async_engine, "
            "deepspeed_tpu_torch.resilience, deepspeed_tpu_torch.resilience.integrity, "
            "deepspeed_tpu_torch.checkpoint, deepspeed_tpu_torch.checkpoint.zero_to_fp32, "
            "deepspeed_tpu_torch.checkpoint.universal, deepspeed_tpu_torch.comm, "
            "deepspeed_tpu_torch.comm.benchmark, deepspeed_tpu_torch.parallel.mesh, "
            "deepspeed_tpu_torch.runtime.zero.planner, "
            "deepspeed_tpu_torch.runtime.zero.partition, "
            "deepspeed_tpu_torch.runtime.zero.tiling, deepspeed_tpu_torch.zero, "
            "deepspeed_tpu_torch.utils.comms_logging, "
            "deepspeed_tpu_torch.module_inject, deepspeed_tpu_torch.module_inject.load, "
            "deepspeed_tpu_torch.module_inject.policies, "
            "deepspeed_tpu_torch.module_inject.sharded_load, "
            "deepspeed_tpu_torch.ops.quantizer, deepspeed_tpu_torch.ops.quantizer.quantizer, "
            "deepspeed_tpu_torch.inference.quantization, "
            "deepspeed_tpu_torch.inference.kv_tiering, deepspeed_tpu_torch.inference.adapters, "
            "deepspeed_tpu_torch.inference.speculative, "
            "deepspeed_tpu_torch.inference.serving_supervisor, deepspeed_tpu_torch.runtime.lora, "
            "deepspeed_tpu_torch.resilience.fault_injection, deepspeed_tpu_torch.observability, "
            "deepspeed_tpu_torch.observability.trace, "
            "deepspeed_tpu_torch.observability.flight_recorder, "
            "deepspeed_tpu_torch.observability.slo, "
            "deepspeed_tpu_torch.observability.export, "
            "deepspeed_tpu_torch.observability.program_stats, "
            "deepspeed_tpu_torch.observability.device_profiler, "
            "deepspeed_tpu_torch.observability.trace_assembly, "
            "deepspeed_tpu_torch.resilience.watchdog, "
            "deepspeed_tpu_torch.moe, deepspeed_tpu_torch.moe.sharded_moe, "
            "deepspeed_tpu_torch.moe.layer, deepspeed_tpu_torch.runtime.pipe, "
            "deepspeed_tpu_torch.runtime.pipe.schedule, "
            "deepspeed_tpu_torch.runtime.pipe.module, "
            "deepspeed_tpu_torch.runtime.pipe.executor, "
            "deepspeed_tpu_torch.runtime.features, "
            "deepspeed_tpu_torch.runtime.progressive_layer_drop, "
            "deepspeed_tpu_torch.runtime.data_pipeline, "
            "deepspeed_tpu_torch.runtime.data_pipeline.data_routing, "
            "deepspeed_tpu_torch.runtime.eigenvalue, "
            "deepspeed_tpu_torch.runtime.sparse_tensor, "
            "deepspeed_tpu_torch.runtime.hybrid_engine, "
            "deepspeed_tpu_torch.compression, deepspeed_tpu_torch.compression.compress, "
            "deepspeed_tpu_torch.compression.prune, deepspeed_tpu_torch.compression.quantize, "
            "deepspeed_tpu_torch.profiling, deepspeed_tpu_torch.profiling.flops_profiler, "
            "deepspeed_tpu_torch.profiling.flops_profiler.profiler, "
            "deepspeed_tpu_torch.autotuning, deepspeed_tpu_torch.autotuning.autotuner, "
            "deepspeed_tpu_torch.monitor, deepspeed_tpu_torch.monitor.monitor, "
            "deepspeed_tpu_torch.utils.debug, deepspeed_tpu_torch.utils.init_on_device, "
            "deepspeed_tpu_torch.utils.compile_counter, deepspeed_tpu_torch.elasticity, "
            "deepspeed_tpu_torch.elasticity.elasticity, "
            "deepspeed_tpu_torch.elasticity.elastic_agent, "
            "deepspeed_tpu_torch.elasticity.supervisor, deepspeed_tpu_torch.launcher, "
            "deepspeed_tpu_torch.launcher.runner, deepspeed_tpu_torch.launcher.launch, "
            "deepspeed_tpu_torch.launcher.multinode_runner, "
            "deepspeed_tpu_torch.launcher.ds_ssh, "
            "deepspeed_tpu_torch.env_report\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_directory_load_imports_no_optional_packages(tmp_path):
    """``init_inference(<HF directory>)`` reads config.json as a dict and
    safetensors through the port's own reader: neither ``transformers``,
    ``safetensors`` nor ``ml_dtypes`` is imported (all are present here)."""
    d, L, f, V = 16, 2, 32, 64
    code = (
        "import json, os, sys, torch\n"
        "from deepspeed_tpu_torch.module_inject.sharded_load import save_safetensors\n"
        "import deepspeed_tpu_torch as ds\n"
        f"d, L, f, V, out = {d}, {L}, {f}, {V}, {str(tmp_path)!r}\n"
        "g = torch.Generator().manual_seed(0)\n"
        "t = lambda *s: torch.randn(s, generator=g).to(torch.bfloat16)\n"
        "sd = {'model.embed_tokens.weight': t(V, d), 'model.norm.weight': t(d),\n"
        "      'lm_head.weight': t(V, d)}\n"
        "for i in range(L):\n"
        "    p = f'model.layers.{i}.'\n"
        "    sd.update({p + 'input_layernorm.weight': t(d),\n"
        "               p + 'post_attention_layernorm.weight': t(d),\n"
        "               **{p + f'self_attn.{n}_proj.weight': t(d, d) for n in 'qkvo'},\n"
        "               p + 'mlp.gate_proj.weight': t(f, d), p + 'mlp.up_proj.weight': t(f, d),\n"
        "               p + 'mlp.down_proj.weight': t(d, f)})\n"
        "save_safetensors(sd, os.path.join(out, 'model.safetensors'))\n"
        "json.dump({'model_type': 'llama', 'vocab_size': V, 'hidden_size': d,\n"
        "           'intermediate_size': f, 'num_hidden_layers': L,\n"
        "           'num_attention_heads': 4}, open(os.path.join(out, 'config.json'), 'w'))\n"
        "eng = ds.init_inference(out, config={'dtype': 'bf16'}, device='cpu')\n"
        "assert torch.equal(eng.params['layers']['wq'][1], sd['model.layers.1.self_attn.q_proj.weight'].T)\n"
        "eng.forward(torch.zeros((1, 4), dtype=torch.long))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        f"       {FORBIDDEN + ('transformers', 'safetensors', 'ml_dtypes')!r}]\n"
        "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_ops_exports_sparse_attention_and_the_layer_api():
    """``deepspeed_tpu_torch.ops`` exports both new modules, whichever is
    imported first (``ops.transformer`` builds on ``models.transformer``,
    which imports ``ops``), and loads no jax."""
    code = ("import sys\n"
            "import deepspeed_tpu_torch.ops as ops\n"
            "assert ops.__all__ == ['sparse_attention', 'transformer']\n"
            "ops.transformer.DeepSpeedTransformerLayer\n"
            "ops.sparse_attention.SparseSelfAttention\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
            "sys.exit(1 if bad else 0)")
    for first in ("", "import deepspeed_tpu_torch.ops.transformer\n"):
        res = subprocess.run([sys.executable, "-c", first + code], cwd=str(ROOT),
                             env=_clean_env(), capture_output=True, text=True,
                             timeout=120)
        assert res.returncode == 0, res.stdout + res.stderr


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]


def test_no_module_of_the_port_imports_forbidden_packages():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = [f"{f.relative_to(ROOT)}:{line} imports {mod}"
           for f in files for line, mod in _imported_roots(f)
           if mod in FORBIDDEN]
    assert not bad, bad


def test_entry_points_default_to_cuda_and_refuse_to_run_on_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    code = ("import deepspeed_tpu_torch as ds\n"
            "from deepspeed_tpu_torch.models import CausalLM\n"
            "m = CausalLM('tiny')\n"
            "p = m.init_fn(device='cpu')\n"
            "for name, call in (('init_fn', m.init_fn),\n"
            "                   ('init_cache', lambda: m.init_cache(1, 128)),\n"
            "                   ('init_inference',\n"
            "                    lambda: ds.init_inference(m, params=p)),\n"
            "                   ('init_paged_cache', lambda: m.init_paged_cache(3, 8)),\n"
            "                   ('initialize',\n"
            "                    lambda: ds.initialize(model=m, params=p,\n"
            "                                          config={'train_batch_size': 1}))):\n"
            "    try:\n"
            "        call()\n"
            "    except RuntimeError as e:\n"
            "        print(name, 'raised:', e)\n"
            "    else:\n"
            "        raise SystemExit(name + ' ran without a card')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    for name in ("init_fn", "init_cache", "init_inference", "init_paged_cache",
                 "initialize"):
        assert f"{name} raised:" in res.stdout, res.stdout
    assert res.stdout.count("torch.cuda.is_available() is False") == 5


def test_cpu_accelerator_only_when_asked(monkeypatch):
    from deepspeed_tpu_torch.accelerator import real_accelerator as ra

    monkeypatch.setattr(ra, "_accelerator", None)
    monkeypatch.delenv("DS_ACCELERATOR", raising=False)
    assert ra.get_accelerator().name() == "cuda"
    assert ra.get_accelerator().communication_backend_name() == "nccl"
    monkeypatch.setattr(ra, "_accelerator", None)
    monkeypatch.setenv("DS_ACCELERATOR", "cpu")
    acc = ra.get_accelerator()
    assert acc.name() == "cpu" and acc.communication_backend_name() == "gloo"
    assert ra.resolve_device() == torch.device("cpu")
    assert acc.memory_stats()["bytes_limit"] > 0
    monkeypatch.setattr(ra, "_accelerator", None)
    monkeypatch.setenv("DS_ACCELERATOR", "tpu")
    with pytest.raises(ValueError):
        ra.get_accelerator()
    monkeypatch.setattr(ra, "_accelerator", None)
