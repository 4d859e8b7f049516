"""The port's autotuner (``deepspeed_tpu_torch/autotuning``) against the
JAX package's.

The search itself is the JAX package's numpy code, so it is held equal:
``sweeps``, ``_features`` and ``_ridge_fit`` exactly, and the model-based
tuner's sequence of measured candidates and its pick under one synthetic
measure (a deterministic cost landscape standing in for ``_measure`` in
both packages: no test reads a wall clock).  The trial itself is the
port's: an engine factory raising ``torch.OutOfMemoryError`` is recorded
``compile_oom`` (and fast mode ends its sweep there), and a tiny
end-to-end ``autotune`` on the CPU writes the JAX package's files, whose
bytes equal JAX's for the same records.
"""
import json
import os

import numpy as np
import pytest
import torch

from deepspeed_tpu.autotuning import autotuner as JA

import deepspeed_tpu_torch.autotuning.autotuner as TA
from deepspeed_tpu_torch.autotuning import Autotuner, AutotuningConfig, TrialRecord, autotune
from deepspeed_tpu_torch.models import CausalLM

torch.set_num_threads(1)

DEEP = dict(mbs_candidates=[1, 2, 4, 8], zero_stages=[0, 2, 3], seq_lens=[256, 512],
            gas_candidates=[1, 2], offload_devices=[None, "cpu"])


def _step_time(ov) -> float:
    """A cost landscape over (mb, stage, seq, gas, offload): fixed(stage) +
    offload tax + gas tax + mb * (c1 S + c2 S^2) + c3 mb^2 (the shape the
    cost model's features describe)."""
    mb = ov["train_micro_batch_size_per_gpu"]
    zo = ov["zero_optimization"]
    S = ov.get("_seq_len", 512) / 512.0
    gas = ov.get("gradient_accumulation_steps", 1)
    a = {0: 0.05, 1: 0.045, 2: 0.035, 3: 0.06}[zo["stage"]]
    if (zo.get("offload_optimizer") or {}).get("device") == "cpu":
        a += 0.03
    return a + 0.004 * gas + mb * (0.8e-3 * S + 0.9e-3 * S * S) + 2.5e-4 * mb ** 2


def _synthetic_measure(record_cls):
    def measure(self, overrides):
        rec = record_cls(config_overrides=overrides, status="ok")
        samples = (overrides["train_micro_batch_size_per_gpu"]
                   * overrides.get("gradient_accumulation_steps", 1))
        if overrides["train_micro_batch_size_per_gpu"] >= 8 \
                and overrides["zero_optimization"]["stage"] == 0:
            rec.status, rec.error = "compile_oom", "synthetic"
            return rec
        rec.metric_val = samples / _step_time(overrides)
        return rec
    return measure


def _pair(tmp_path, **kw):
    jcfg = JA.AutotuningConfig(enabled=True, results_dir=str(tmp_path / "jax"), **kw)
    tcfg = AutotuningConfig(enabled=True, results_dir=str(tmp_path / "port"), **kw)
    return (JA.Autotuner(lambda ov: None, lambda e: None, jcfg),
            Autotuner(lambda ov: None, lambda e: None, tcfg))


@pytest.mark.parametrize("tuner_type", ["gridsearch", "random"])
def test_sweeps_match_jax(tmp_path, tuner_type):
    j, t = _pair(tmp_path, tuner_type=tuner_type, remat_policies=["nothing_saveable", None],
                 attn_impls=["auto"], pp_sizes=[1, 2], **DEEP)
    assert t.sweeps() == j.sweeps()
    j, t = _pair(tmp_path)
    assert t.sweeps() == j.sweeps() and len(t.sweeps()) == 4


def test_features_and_ridge_fit_match_jax(tmp_path):
    j, t = _pair(tmp_path, **DEEP)
    cands = [ov for sweep in t.sweeps() for ov in sweep]
    space = {"stages": [0, 2, 3], "remats": [None], "attns": [None],
             "offloads": [None, "cpu"], "pps": [None], "seq_default": 256.0,
             "seq_scale": 512.0}
    for extra in ({}, {"dense_coeff": 0.8, "attn_coeff": 0.2}):
        sp = {**space, **extra}
        X = np.stack([Autotuner._features(ov, sp) for ov in cands])
        np.testing.assert_array_equal(
            X, np.stack([JA.Autotuner._features(ov, sp) for ov in cands]))
    t_obs = np.asarray([_step_time(ov) for ov in cands])
    np.testing.assert_array_equal(Autotuner._ridge_fit(X, t_obs),
                                  JA.Autotuner._ridge_fit(X, t_obs))


@pytest.mark.parametrize("max_trials", [6, 10])
def test_model_based_pick_matches_jax(tmp_path, monkeypatch, max_trials):
    """The model-based tuner measures the same candidates in the same
    order and picks the same one (a synthetic OOM at mb >= 8 on stage 0
    included)."""
    monkeypatch.setattr(JA.Autotuner, "_measure", _synthetic_measure(JA.TrialRecord))
    monkeypatch.setattr(TA.Autotuner, "_measure", _synthetic_measure(TrialRecord))
    j, t = _pair(tmp_path, tuner_type="model_based", max_trials=max_trials, seed_trials=4,
                 **DEEP)
    jbest, jrec = j.tune()
    tbest, trec = t.tune()
    assert [r.config_overrides for r in trec] == [r.config_overrides for r in jrec]
    assert [r.status for r in trec] == [r.status for r in jrec]
    assert tbest == jbest and tbest is not None
    with open(tmp_path / "port" / "records.json") as f, \
            open(tmp_path / "jax" / "records.json") as g:
        assert f.read() == g.read()
    with open(tmp_path / "port" / "best_config.json") as f, \
            open(tmp_path / "jax" / "best_config.json") as g:
        assert f.read() == g.read()


def test_gridsearch_fast_mode_matches_jax(tmp_path, monkeypatch):
    """Fast mode ends a sweep at its first OOM or throughput regression."""
    monkeypatch.setattr(JA.Autotuner, "_measure", _synthetic_measure(JA.TrialRecord))
    monkeypatch.setattr(TA.Autotuner, "_measure", _synthetic_measure(TrialRecord))
    j, t = _pair(tmp_path, mbs_candidates=[1, 2, 4, 8, 16, 32, 64], zero_stages=[0, 2])
    jbest, jrec = j.tune()
    tbest, trec = t.tune()
    assert [r.config_overrides for r in trec] == [r.config_overrides for r in jrec]
    assert tbest == jbest
    assert [r.status for r in trec if r.config_overrides["zero_optimization"]["stage"] == 0][-1] \
        == "compile_oom"


class _OOMEngine:
    train_batch_size = 1


def test_out_of_memory_is_a_compile_oom_record(tmp_path):
    """An engine factory (or a step) raising ``torch.OutOfMemoryError``:
    ``compile_oom``, the larger micro-batches of its sweep not tried, the
    engine freed; ``compile_prune`` probes the same way."""
    built = []

    def make_engine(ov):
        mb = ov["train_micro_batch_size_per_gpu"]
        built.append(mb)
        if mb >= 4:
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 9 GiB")
        eng = _OOMEngine()
        eng.train_batch = lambda batch=None: torch.tensor(1.0)
        eng.train_batch_size = mb
        return eng

    cfg = AutotuningConfig(enabled=True, zero_stages=[0], mbs_candidates=[1, 4, 16],
                           start_profile_step=1, end_profile_step=2,
                           results_dir=str(tmp_path / "r"))
    best, records = Autotuner(make_engine, lambda e: None, cfg).tune()
    assert [r.status for r in records] == ["ok", "compile_oom"] and built == [1, 4]
    assert "out of memory" in records[1].error.lower()
    assert best == {"zero_optimization": {"stage": 0}, "train_micro_batch_size_per_gpu": 1}
    recs = Autotuner(make_engine, lambda e: None, cfg).compile_prune(
        [{"zero_optimization": {"stage": 0}, "train_micro_batch_size_per_gpu": m}
         for m in (1, 16)])
    assert [r.status for r in recs] == ["ok", "compile_oom"]

    def broken(ov):
        raise ValueError("bad config")

    rec = Autotuner(broken, lambda e: None, cfg).compile_prune(
        [{"zero_optimization": {"stage": 0}, "train_micro_batch_size_per_gpu": 1}])[0]
    assert rec.status == "compile_error" and "bad config" in rec.error


def test_budget_is_the_cards_memory(monkeypatch):
    assert TA.device_memory_bytes("cpu") == 1 << 62
    assert AutotuningConfig().hbm_bytes is None   # not JAX's 16 GiB of a v5e
    assert JA.DEFAULT_HBM_BYTES == 16 * 1024 ** 3
    assert TA.MEMORY_SAFETY_MARGIN == JA.MEMORY_SAFETY_MARGIN
    rec = TrialRecord(config_overrides={}, status="ok")
    assert not TA._apply_budget(rec, 10 ** 9, 10 ** 9) and rec.status == "compile_oom"
    rec = TrialRecord(config_overrides={}, status="ok")
    assert TA._apply_budget(rec, 10 ** 8, 10 ** 9) and rec.memory_bytes == 10 ** 8
    with pytest.raises(ValueError, match="unknown autotuning keys"):
        AutotuningConfig.from_dict({"enabled": True, "bogus": 1})
    with pytest.raises(ValueError, match="not enabled"):
        Autotuner(lambda ov: None, lambda e: None, AutotuningConfig()).tune()


def test_tiny_autotune_end_to_end_writes_the_results(tmp_path):
    """``autotune`` on the CPU over ZeRO stage {0, 1} x micro-batch {1, 2}
    with a remat override: every trial trains, the files are written, the
    best config merges the winner into the base config."""
    rd = str(tmp_path / "results")
    base = {"bf16": {"enabled": True}, "steps_per_print": 10 ** 9,
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
            "autotuning": {"enabled": True, "mbs_candidates": [1, 2], "zero_stages": [0, 1],
                           "remat_policies": ["nothing_saveable"], "fast": False,
                           "start_profile_step": 1, "end_profile_step": 2,
                           "results_dir": rd}}
    seen = []

    def batch_factory(engine):
        seen.append((engine.model.config.remat_policy, engine.train_batch_size))
        return {"input_ids": np.random.default_rng(0).integers(
            0, 256, (engine.train_batch_size, 32))}

    best, records = autotune(lambda: CausalLM("tiny", dtype=torch.bfloat16, max_seq_len=32,
                                              remat=True),
                             base, batch_factory, device="cpu")
    assert [r.status for r in records] == ["ok"] * 4, [r.error for r in records]
    assert all(r.metric_val > 0 for r in records)
    assert sorted(seen) == [("nothing_saveable", 1)] * 2 + [("nothing_saveable", 2)] * 2
    assert best["_remat_policy"] == "nothing_saveable" and "autotuning" not in best
    assert best["zero_optimization"]["stage"] in (0, 1)
    assert sorted(os.listdir(rd)) == ["best_config.json", "records.json"]
    recs = json.load(open(os.path.join(rd, "records.json")))
    assert [sorted(r) for r in recs] == [sorted(JA.TrialRecord(
        config_overrides={}, status="ok").as_dict())] * 4
    bc = json.load(open(os.path.join(rd, "best_config.json")))
    assert bc["metric"] == "throughput" and bc["metric_val"] > 0
