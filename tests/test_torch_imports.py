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
            "deepspeed_tpu_torch.ops.kernels.flash_attention, "
            "deepspeed_tpu_torch.runtime.engine, deepspeed_tpu_torch.runtime.config, "
            "deepspeed_tpu_torch.runtime.optimizer, "
            "deepspeed_tpu_torch.runtime.lr_schedules, "
            "deepspeed_tpu_torch.runtime.fp16.loss_scaler, "
            "deepspeed_tpu_torch.runtime.dataloader, deepspeed_tpu_torch.utils.timer\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
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
    for name in ("init_fn", "init_cache", "init_inference", "initialize"):
        assert f"{name} raised:" in res.stdout, res.stdout
    assert res.stdout.count("torch.cuda.is_available() is False") == 4


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
