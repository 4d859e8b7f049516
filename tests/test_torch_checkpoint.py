"""The port's checkpointing: bit-exact resume, partial loads, the ``latest``
pointer and tags, integrity checks, async commit, and fp32 exports carried
across packages.

Resume is held bit for bit (``torch.equal``) on losses, every parameter,
every optimizer-state tensor and the loss scaler: a run saved after k steps
and resumed in a fresh engine continues exactly as the run that never
stopped, with dropout on (the generator's state is saved), across fp16
overflows (the scaler's state), at gas 2 and under WarmupLR (the step and
the optimizer's own count).  Partial loads follow the JAX package's
``dataclasses_replace_state``: ``load_module_only`` keeps the engine's
optimizer state, step, scaler and generator; ``load_optimizer_states=False``
keeps its optimizer state.

Across packages the weights travel as the flat ``{'a/b/c': fp32}`` export
of ``zero_to_fp32``: a JAX engine's export (``.npz``) loads into the port's
tree and the port's logits equal the JAX model's at atol/rtol 1e-4 (the
tolerance of ``test_torch_model.py``: summation order only), and the
port's export loads into the JAX tree by the same names with the same
tolerance.
"""
import json
import os
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch as ds
from deepspeed_tpu.models import CausalLM as JaxCausalLM
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.parallel import mesh as mesh_mod
from deepspeed_tpu_torch.checkpoint import (
    checkpoint_info, convert_zero_checkpoint_to_fp32_state_dict,
    get_fp32_state_dict_from_zero_checkpoint, inspect_checkpoint,
    load_fp32_state_dict, load_state_dict_from_zero_checkpoint,
    state_dict_to_params, validate_checkpoint)
from deepspeed_tpu_torch.models import CausalLM
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.resilience import (CheckpointIntegrityError,
                                            candidate_tags, quarantine_tag,
                                            read_tag_step, verify_checkpoint_dir)
from deepspeed_tpu_torch.runtime.checkpoint_engine import async_engine
from deepspeed_tpu_torch.runtime.checkpoint_engine.dcp_engine import (
    engine_state_dict, save_16bit_model)
from deepspeed_tpu_torch.utils.tree import tree_leaves

S = 32
TOL = dict(atol=1e-4, rtol=1e-4)


def _config(**extra):
    cfg = {"train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": 1,
           "optimizer": {"type": "adamw",
                         "params": {"lr": 3e-3, "weight_decay": 0.1}},
           "gradient_clipping": 1.0, "steps_per_print": 10 ** 9}
    cfg.update(extra)
    return cfg


def _engine(config, name="tiny", dtype=torch.float32, **model_kw):
    model = CausalLM(name, dtype=dtype, **model_kw)
    engine, *_ = ds.initialize(model=model, config=config, device="cpu")
    return engine


def _batches(n, B, seed=1, vocab=256):
    rs = np.random.RandomState(seed)
    return [{"input_ids": rs.randint(0, vocab, (B, S)).astype(np.int64)}
            for _ in range(n)]


def _assert_same_state(a, b):
    fa, fb = engine_state_dict(a), engine_state_dict(b)
    assert sorted(fa) == sorted(fb)
    for key in fa:
        assert torch.equal(fa[key], fb[key]), key
    assert a.state.scaler == b.state.scaler
    assert (a.global_steps, a.skipped_steps, a.micro_steps) == \
        (b.global_steps, b.skipped_steps, b.micro_steps)


RESUME_CASES = {
    "dropout": (dict(), dict(dropout=0.2)),
    "fp16-overflow": (dict(fp16={"enabled": True, "initial_scale_power": 24,
                                 "loss_scale_window": 2, "hysteresis": 2}),
                      dict(dtype=torch.float16)),
    "gas2": (dict(train_micro_batch_size_per_gpu=2, gradient_accumulation_steps=2),
             dict()),
    "warmup": (dict(scheduler={"type": "WarmupLR",
                               "params": {"warmup_min_lr": 0.0,
                                          "warmup_max_lr": 3e-3,
                                          "warmup_num_steps": 6}}), dict()),
}


@pytest.mark.parametrize("case", sorted(RESUME_CASES))
def test_resume_is_bit_exact(case, tmp_path):
    extra, model_kw = RESUME_CASES[case]
    cfg = _config(**extra)
    batches = _batches(7, 4, seed=2)
    a = _engine(cfg, **model_kw)
    for b in batches[:4]:
        a.train_batch(batch=b)
    a.save_checkpoint(str(tmp_path))
    if case == "fp16-overflow":
        assert a.skipped_steps > 0
    tail_a = [a.train_batch(batch=b) for b in batches[4:]]
    fresh = _engine({**cfg, "seed": 7}, **model_kw)
    path, client = fresh.load_checkpoint(str(tmp_path))
    assert path == str(tmp_path / "global_step4") and client == {}
    tail_b = [fresh.train_batch(batch=b) for b in batches[4:]]
    for x, y in zip(tail_a, tail_b):
        assert torch.equal(x, y)
    _assert_same_state(a, fresh)
    if case == "warmup":
        assert a.get_current_lr() == fresh.get_current_lr() == 3e-3
    if case == "fp16-overflow":
        assert fresh.skipped_steps > 0 and fresh.loss_scale == a.loss_scale


def test_partial_loads_follow_jax(tmp_path):
    cfg = _config()
    batches = _batches(4, 4, seed=3)
    src = _engine(cfg, dropout=0.1)
    for b in batches[:2]:
        src.train_batch(batch=b)
    src.save_checkpoint(str(tmp_path), client_state={"epoch": 3})
    saved = {k: v.clone() for k, v in engine_state_dict(src).items()}

    def fresh():
        e = _engine({**cfg, "seed": 11}, dropout=0.1)
        e.train_batch(batch=batches[3])
        return e, {k: v.clone() for k, v in engine_state_dict(e).items()}

    for kwargs, from_ckpt in (
            (dict(load_module_only=True), ("params/",)),
            (dict(load_optimizer_states=False), ("params/", "step", "scaler/", "rng/"))):
        e, own = fresh()
        _, client = e.load_checkpoint(str(tmp_path), **kwargs)
        assert client == {"epoch": 3}
        now = engine_state_dict(e)
        for key, value in now.items():
            want = saved[key] if key.startswith(from_ckpt) else own[key]
            assert torch.equal(value, want), (kwargs, key)
        assert e.global_steps == 2   # counters come from client_state.json
        e.train_batch(batch=batches[2])


def test_latest_tags_and_client_state(tmp_path):
    d = str(tmp_path)
    e = _engine(_config())
    assert e.load_checkpoint(d) == (None, {})
    batches = _batches(3, 4, seed=4)
    e.train_batch(batch=batches[0])
    p1 = e.save_checkpoint(d, client_state={"epoch": 1, "note": "first"})
    e.train_batch(batch=batches[1])
    p2 = e.save_checkpoint(d, client_state={"epoch": 2})
    e.train_batch(batch=batches[2])
    e.save_checkpoint(d, tag="manual", save_latest=False)
    assert os.path.basename(p1) == "global_step1"
    assert os.path.basename(p2) == "global_step2"
    with open(os.path.join(d, "latest")) as f:
        assert f.read() == "global_step2"
    assert sorted(os.listdir(p2)) == ["client_state.json", "ds_config.json",
                                      "manifest.json", "state"]
    with open(os.path.join(p2, "client_state.json")) as f:
        meta = json.load(f)
    assert {"checkpoint_version", "global_steps", "skipped_steps", "micro_steps",
            "param_count", "zero_stage", "mesh_shape", "client_state"} <= set(meta)
    other = _engine(_config())
    assert other.load_checkpoint(d)[1] == {"epoch": 2}
    assert other.global_steps == 2
    assert other.load_checkpoint(d, tag="global_step1")[1] == {"epoch": 1,
                                                               "note": "first"}
    assert other.global_steps == 1
    other.load_checkpoint(d, tag="manual")
    _assert_same_state(other, e)
    with pytest.raises(FileNotFoundError):
        other.load_checkpoint(d, tag="global_step9")
    info = validate_checkpoint(d, param_count=e.param_count)
    assert info["tag"] == "global_step2" and checkpoint_info(d)["global_steps"] == 2
    with pytest.raises(ValueError, match="param"):
        validate_checkpoint(d, param_count=e.param_count + 1)
    rows = {r["name"]: r for r in inspect_checkpoint(d)}
    assert rows["params/embed"]["shape"] == (256, 64)
    assert rows["params/embed"]["bytes"] == 256 * 64 * 4
    assert "rng/dropout" in rows and "opt_state/1/0/mu/embed" in rows
    with pytest.raises(RuntimeError, match="open forward/backward window"):
        e.forward(batches[0])
        e.save_checkpoint(d)


def _saved(tmp_path, steps=1):
    e = _engine(_config())
    for b in _batches(steps, 4, seed=5):
        e.train_batch(batch=b)
    return e, e.save_checkpoint(str(tmp_path))


def test_torn_save_is_refused(tmp_path):
    e, path = _saved(tmp_path)
    open(os.path.join(path, ".incomplete"), "w").close()
    with pytest.raises(CheckpointIntegrityError, match="torn save"):
        _engine(_config()).load_checkpoint(str(tmp_path))
    off = _engine(_config(resilience={"verify_on_load": False}))
    off.load_checkpoint(str(tmp_path))
    _assert_same_state(off, e)


def test_flipped_payload_byte_fails_checksum(tmp_path):
    _, path = _saved(tmp_path)
    verify_checkpoint_dir(path)
    state = os.path.join(path, "state")
    big = max((os.path.join(state, n) for n in os.listdir(state)),
              key=os.path.getsize)
    with open(big, "r+b") as f:
        f.seek(os.path.getsize(big) // 2)
        byte = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([byte[0] ^ 0x01]))
    fresh = _engine(_config())
    before = {k: v.clone() for k, v in engine_state_dict(fresh).items()}
    with pytest.raises(CheckpointIntegrityError, match="checksum mismatch"):
        fresh.load_checkpoint(str(tmp_path))
    for key, value in engine_state_dict(fresh).items():   # nothing touched
        assert torch.equal(value, before[key])


def test_legacy_tag_without_manifest_loads(tmp_path):
    e, path = _saved(tmp_path)
    os.remove(os.path.join(path, "manifest.json"))
    assert verify_checkpoint_dir(path) is None
    fresh = _engine(_config())
    fresh.load_checkpoint(str(tmp_path))
    _assert_same_state(fresh, e)


def test_quarantine_and_fallback(tmp_path):
    d = str(tmp_path)
    e = _engine(_config())
    for b in _batches(2, 4, seed=6):
        e.train_batch(batch=b)
        e.save_checkpoint(d)
    assert candidate_tags(d) == ["global_step2", "global_step1"]
    assert read_tag_step(os.path.join(d, "global_step2")) == 2
    with open(os.path.join(d, "global_step2", "client_state.json"), "a") as f:
        f.write(" ")
    with pytest.raises(CheckpointIntegrityError, match="client_state.json"):
        verify_checkpoint_dir(os.path.join(d, "global_step2"))
    moved = quarantine_tag(d, "global_step2")
    assert moved.endswith("global_step2.corrupt") and not os.path.exists(
        os.path.join(d, "latest"))
    assert candidate_tags(d) == ["global_step1"]
    fresh = _engine(_config())
    fresh.load_checkpoint(d, tag=candidate_tags(d)[0])
    assert fresh.global_steps == 1


def test_async_save_publishes_latest_only_when_durable(tmp_path, monkeypatch):
    d = str(tmp_path)
    cfg = _config(checkpoint={"async_save": True})
    batches = _batches(4, 4, seed=7)
    a = _engine(cfg, dropout=0.1)
    a.train_batch(batch=batches[0])
    a.save_checkpoint(d)
    a.wait_for_checkpoint()
    release = threading.Event()
    commit = async_engine.AsyncCheckpointEngine.commit

    def held_commit(self, tag):
        assert release.wait(30)
        return commit(self, tag)

    monkeypatch.setattr(async_engine.AsyncCheckpointEngine, "commit", held_commit)
    a.train_batch(batch=batches[1])
    path = a.save_checkpoint(d)
    # returned after the snapshot: the engine trains on while the write waits
    tail_a = [a.train_batch(batch=b) for b in batches[2:]]
    with open(os.path.join(d, "latest")) as f:
        assert f.read() == "global_step1"
    assert os.path.exists(os.path.join(path, ".incomplete"))
    assert not os.path.exists(os.path.join(path, "manifest.json"))
    release.set()
    a.wait_for_checkpoint()
    with open(os.path.join(d, "latest")) as f:
        assert f.read() == "global_step2"
    verify_checkpoint_dir(path)
    fresh = _engine(cfg, dropout=0.1)
    fresh.load_checkpoint(d)
    for x, y in zip(tail_a, [fresh.train_batch(batch=b) for b in batches[2:]]):
        assert torch.equal(x, y)
    _assert_same_state(a, fresh)


def test_async_save_failure_surfaces_and_keeps_latest(tmp_path, monkeypatch):
    d = str(tmp_path)
    e = _engine(_config(checkpoint={"async_save": True}))
    e.train_batch(batch=_batches(1, 4, seed=8)[0])
    e.save_checkpoint(d, tag="good")
    e.wait_for_checkpoint()

    def broken(self, tag):
        raise OSError("disk full")

    monkeypatch.setattr(async_engine.AsyncCheckpointEngine, "commit", broken)
    e.save_checkpoint(d, tag="bad")
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        e.wait_for_checkpoint()
    with open(os.path.join(d, "latest")) as f:
        assert f.read() == "good"
    with pytest.raises(CheckpointIntegrityError, match="torn save"):
        verify_checkpoint_dir(os.path.join(d, "bad"))
    e.wait_for_checkpoint()   # the error is reported once


def test_fp32_export_round_trip(tmp_path):
    e, _ = _saved(tmp_path, steps=2)
    e16 = _engine(_config(bf16={"enabled": True}), dtype=torch.bfloat16)
    e16.train_batch(batch=_batches(1, 4, seed=9)[0])
    d16 = tmp_path / "bf16"
    e16.save_checkpoint(str(d16))
    sd = get_fp32_state_dict_from_zero_checkpoint(str(d16))
    for (name, master), (_, got) in zip(
            sorted(_flat(e16.get_params(fp32=True)).items()), sorted(sd.items())):
        assert got.dtype == torch.float32 and torch.equal(got, master), name
    template = CausalLM("tiny").init_fn(device="cpu")
    for fmt in ("npz", "pt"):
        out = str(tmp_path / f"w.{fmt}")
        convert_zero_checkpoint_to_fp32_state_dict(str(tmp_path), out)
        loaded = state_dict_to_params(load_fp32_state_dict(out), template)
        for a, b in zip(tree_leaves(loaded), tree_leaves(e.get_params())):
            assert torch.equal(a, b)
    direct = load_state_dict_from_zero_checkpoint(template, str(tmp_path))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(direct),
                                                 tree_leaves(e.get_params())))
    with pytest.raises(KeyError, match="no tensor for param"):
        state_dict_to_params({}, template)
    p16 = save_16bit_model(e16, str(tmp_path / "w16"))
    assert os.path.isdir(p16)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _jax_logits(model, params, tokens):
    return np.asarray(model.apply_fn(params, jnp.asarray(tokens)))


def test_jax_export_loads_into_port(tmp_path):
    from deepspeed_tpu.checkpoint import convert_zero_checkpoint_to_fp32_state_dict \
        as jax_convert

    name = "tiny-gqa"
    jmodel = JaxCausalLM(name, dtype=jnp.float32)
    mesh_mod.reset_mesh()
    try:
        mesh = mesh_mod.initialize_mesh(mesh_mod.MeshLayout.from_world(1),
                                        devices=jax.devices()[:1])
        jeng, *_ = deepspeed_tpu.initialize(
            model=jmodel, mesh=mesh,
            config={"train_micro_batch_size_per_gpu": 8, "steps_per_print": 10 ** 9})
        jeng.save_checkpoint(str(tmp_path / "jax"))
    finally:
        mesh_mod.reset_mesh()
    tokens = _batches(1, 8, seed=10)[0]["input_ids"].astype(np.int32)
    out = jax_convert(str(tmp_path / "jax"), str(tmp_path / "jax.npz"))
    model = CausalLM(name, dtype=torch.float32)
    params = state_dict_to_params(load_fp32_state_dict(out),
                                  model.init_fn(device="cpu"))
    got = model.apply_fn(params, torch.from_numpy(tokens)).detach().numpy()
    np.testing.assert_allclose(got, _jax_logits(jmodel, jeng.get_params(), tokens),
                               **TOL)


def test_port_export_loads_into_jax(tmp_path):
    from deepspeed_tpu.utils.debug import path_str

    name = "tiny-gpt2"
    e = _engine(_config(), name=name)
    tokens = _batches(1, 4, seed=11)[0]["input_ids"]
    e.train_batch(batch={"input_ids": tokens})
    e.save_checkpoint(str(tmp_path))
    out = convert_zero_checkpoint_to_fp32_state_dict(str(tmp_path),
                                                     str(tmp_path / "port.npz"))
    with np.load(out) as z:
        flat = {k: z[k] for k in z.files}
    jmodel = JaxCausalLM(name, dtype=jnp.float32)
    template = jtf.init_params(jmodel.config, jax.random.PRNGKey(0))
    jparams = jax.tree_util.tree_map_with_path(
        lambda p, leaf: jnp.asarray(flat[path_str(p)]), template)
    want = e.model.apply_fn(e.get_params(), torch.from_numpy(tokens)).detach().numpy()
    np.testing.assert_allclose(_jax_logits(jmodel, jparams, tokens.astype(np.int32)),
                               want, **TOL)
