"""Autotuner: search the (zero stage x micro-batch x remat) space
(counterpart of ``deepspeed_tpu/autotuning/autotuner.py``; reference
``autotuning/autotuner.py:42``: tuning spaces per ZeRO stage, a
micro-batch sweep with an OOM ceiling, gridsearch / random / model-based
tuners, the fast-mode early exit, the records and the best config
written like the reference's ``autotuning_results``).

The candidate space, the cost model (``_features``, ``_ridge_fit``,
``_tune_model_based``), the fast-mode exits and the results files are the
JAX package's, line for line.  What differs: PyTorch has no ahead-of-time
compile with a memory analysis, so a trial learns its memory by running.
``_measure`` builds the engine, runs the warm-up steps from a reset peak
and records ``torch.cuda.max_memory_allocated`` as ``memory_bytes`` (a
run that fits the card but not the budget is still ``compile_oom``); a
``torch.OutOfMemoryError`` anywhere in the trial is ``compile_oom``, and
the trial's engine is freed (``empty_cache``) before the next.  Steps are
timed between device synchronisations.  ``compile_prune`` is that same
one-step probe, run serially: one card.  The budget is the card's own
memory (``torch.cuda.get_device_properties(dev).total_memory``), not the
JAX package's 16 GiB of a v5e chip.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.logging import log_dist, logger

MEMORY_SAFETY_MARGIN = 0.92              # leave headroom for runtime buffers


def device_memory_bytes(device=None) -> int:
    """The card's memory, the trials' budget (the CPU has none to read:
    the budget is then unbounded)."""
    import torch

    dev = torch.device(device) if device is not None else (
        torch.device("cuda", torch.cuda.current_device())
        if torch.cuda.is_available() else torch.device("cpu"))
    if dev.type != "cuda":
        return 1 << 62
    return int(torch.cuda.get_device_properties(dev).total_memory)


@dataclasses.dataclass
class TrialRecord:
    config_overrides: Dict[str, Any]
    status: str                 # ok | compile_oom | compile_error | run_error
    metric_val: float = 0.0     # samples/sec (throughput) or -sec (latency)
    memory_bytes: int = 0
    compile_sec: float = 0.0
    error: str = ""

    def as_dict(self):
        return dataclasses.asdict(self)



def _apply_budget(rec: TrialRecord, peak_bytes: Optional[int], hbm_bytes: int) -> bool:
    """Record the measured peak; True if the config fits the budget."""
    if peak_bytes is None:
        return True
    rec.memory_bytes = int(peak_bytes)
    if rec.memory_bytes > hbm_bytes * MEMORY_SAFETY_MARGIN:
        rec.status = "compile_oom"
        rec.error = (f"predicted {rec.memory_bytes / 1e9:.2f} GB > "
                     f"budget {hbm_bytes / 1e9:.2f} GB")
        return False
    return True


@dataclasses.dataclass(frozen=True)
class AutotuningConfig:
    """``autotuning`` block (reference constants.py:41-70)."""
    enabled: bool = False
    metric: str = "throughput"            # throughput | latency
    results_dir: str = "autotuning_results"
    overwrite: bool = True
    fast: bool = True                     # stop a sweep on first regression
    tuner_type: str = "gridsearch"        # gridsearch | random | model_based
    max_trials: int = 50
    start_profile_step: int = 2
    end_profile_step: int = 6
    mbs_candidates: Optional[Sequence[int]] = None
    zero_stages: Optional[Sequence[int]] = None
    remat_policies: Optional[Sequence[str]] = None
    # flash-attention dispatch is part of the space (the kernel-vs-plain
    # threshold is config, not a constant)
    attn_impls: Optional[Sequence[str]] = None
    # depth-2 dims: sequence length (model override),
    # gradient-accumulation, optimizer offload, pipeline degree
    seq_lens: Optional[Sequence[int]] = None
    gas_candidates: Optional[Sequence[int]] = None
    offload_devices: Optional[Sequence[Optional[str]]] = None  # None | "cpu"
    pp_sizes: Optional[Sequence[int]] = None
    # model_based: measured seed trials before the cost model takes over
    seed_trials: int = 3
    # accepted for the JAX package's configs: the port probes serially (one
    # card), whatever the value
    parallel_compile: int = 4
    # the budget; None: the card's own memory
    hbm_bytes: Optional[int] = None

    @classmethod
    def from_dict(cls, d: Optional[Dict]) -> "AutotuningConfig":
        d = dict(d or {})
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown autotuning keys: {sorted(unknown)}")
        return cls(**d)


class Autotuner:
    """Grid/random search with memory screening by a probe step.

    ``make_engine(overrides) -> engine`` builds a fresh engine for a
    candidate; ``make_batch(engine) -> batch`` supplies a training batch.
    """

    def __init__(self, make_engine: Callable[[Dict[str, Any]], Any],
                 make_batch: Callable[[Any], Any],
                 config: Optional[AutotuningConfig] = None, model=None,
                 device=None):
        self.make_engine = make_engine
        self.make_batch = make_batch
        self.config = config or AutotuningConfig(enabled=True)
        self.records: List[TrialRecord] = []
        # optional: enables profiler-informed cost-model feature scaling
        # (see _tune_model_based), profiled on ``device``
        self.model = model
        self.device = device

    # -- candidate space (reference _generate_experiments / tune_space) --
    def sweeps(self) -> List[List[Dict[str, Any]]]:
        """One sweep per (stage, remat): micro-batches ascending, so fast
        mode can cut a sweep at the first regression/OOM (reference
        tune_space's prev_best early exit)."""
        c = self.config
        stages = list(c.zero_stages if c.zero_stages is not None else (0, 1, 2, 3))
        mbs = sorted(c.mbs_candidates if c.mbs_candidates is not None
                     else (1, 2, 4, 8, 16, 32))
        remats = list(c.remat_policies if c.remat_policies is not None else (None,))
        attns = list(c.attn_impls if c.attn_impls is not None else (None,))
        seqs = list(c.seq_lens if c.seq_lens is not None else (None,))
        gass = list(c.gas_candidates if c.gas_candidates is not None else (None,))
        offs = list(c.offload_devices if c.offload_devices is not None
                    else (None,))
        pps = list(c.pp_sizes if c.pp_sizes is not None else (None,))
        out = []
        for stage, remat, attn, seq, gas, off, pp in itertools.product(
                stages, remats, attns, seqs, gass, offs, pps):
            sweep = []
            for mb in mbs:
                ov: Dict[str, Any] = {
                    "zero_optimization": {"stage": stage},
                    "train_micro_batch_size_per_gpu": mb,
                }
                if remat is not None:
                    ov["_remat_policy"] = remat
                if attn is not None:
                    ov["_attn_impl"] = attn
                if seq is not None:
                    ov["_seq_len"] = seq
                if gas is not None:
                    ov["gradient_accumulation_steps"] = gas
                if off is not None:
                    ov["zero_optimization"]["offload_optimizer"] = \
                        {"device": off}
                if pp is not None:
                    ov["_pp"] = pp
                sweep.append(ov)
            out.append(sweep)
        if self.config.tuner_type == "random":
            rng = np.random.default_rng(0)
            rng.shuffle(out)
        return out

    # -- cost model (reference autotuning/tuner/model_based_tuner.py +
    #    cost_model.py — theirs is xgboost; ours is quadratic features under
    #    a ridge fit, which survives >100-point grids without a tree lib) --
    @staticmethod
    def _features(ov: Dict[str, Any], space: Dict[str, list]) -> np.ndarray:
        """Step-time features.  Continuous block: [1, mb, mb², S·mb, S²·mb,
        S, gas, gas·mb] — attention work scales mb·S² and matmul work mb·S,
        so per-step time is linear in these; the mb² term models batch-size
        curvature (cache/util effects) so throughput mb/t can peak interior.
        Categorical dims (stage/remat/attn/offload/pp) contribute a fixed
        overhead one-hot AND a per-sample slope one-hot (×mb): ZeRO stage or
        offload changes BOTH the per-step constant (collectives, host sync)
        and the per-sample cost."""
        mb = float(ov["train_micro_batch_size_per_gpu"])
        S = float(ov.get("_seq_len") or space.get("seq_default") or 1.0)
        Sn = S / max(space.get("seq_scale", 1.0), 1.0)   # normalized seq
        gas = float(ov.get("gradient_accumulation_steps", 1))
        if "dense_coeff" in space and "attn_coeff" in space:
            # profiler-informed: ONE physical model-flops column
            # (dc + ac·(S/S₀))·Sn·mb replaces the separate S·mb / S²·mb
            # terms — the per-module profile pins the dense:attention
            # ratio, so the ridge has one fewer free parameter to identify
            # from seed trials.  (Scaling the two columns separately would
            # be a no-op: the per-column max-abs normalization cancels
            # constant scales.)  The coefficients were MEASURED at
            # S₀ = seq_default, and attention flops/token scale linearly
            # in S, so the ratio term must be S/S₀ — normalizing by
            # seq_scale instead would mis-weight attention by
            # seq_scale/seq_default at the profiled point.
            dc = float(space["dense_coeff"])
            ac = float(space["attn_coeff"])
            r = S / max(float(space.get("seq_default", 1.0)), 1.0)
            x = [1.0, mb, mb * mb, (dc + ac * r) * Sn * mb, Sn, gas,
                 gas * mb]
        else:
            x = [1.0, mb, mb * mb, Sn * mb, Sn * Sn * mb, Sn, gas, gas * mb]
        off = (ov["zero_optimization"].get("offload_optimizer") or {}
               ).get("device")
        cats = [("stages", ov["zero_optimization"]["stage"]),
                ("remats", ov.get("_remat_policy")),
                ("attns", ov.get("_attn_impl")),
                ("offloads", off),
                ("pps", ov.get("_pp"))]
        for dim, val in cats:
            for v in space[dim]:
                hit = 1.0 if val == v else 0.0
                x.append(hit)          # fixed overhead
                x.append(hit * mb)     # per-sample slope
        return np.asarray(x, np.float64)

    @staticmethod
    def _ridge_fit(X: np.ndarray, t: np.ndarray, lam: float = 1e-6
                   ) -> np.ndarray:
        """Regularized least squares: stable when measured points are few
        relative to the feature count (the early rounds of a big grid)."""
        n = X.shape[1]
        return np.linalg.solve(X.T @ X + lam * np.eye(n), X.T @ t)

    def compile_prune(self, candidates: List[Dict[str, Any]]
                      ) -> List[TrialRecord]:
        """Memory screening: each candidate's engine takes one step from a
        reset peak (``_probe``), serially — one card.  A record is
        ``compile_oom`` past the budget or on ``torch.OutOfMemoryError``,
        ``compile_error`` on any other failure; ``compile_sec`` is the
        engine's build and first step."""
        out: List[TrialRecord] = []
        for ov in candidates:
            rec = TrialRecord(config_overrides=ov, status="ok")
            self._trial(rec, ov, warm=1, steps=0, error_status="compile_error")
            out.append(rec)
        return out

    def _tune_model_based(self) -> Optional[TrialRecord]:
        """Fit step-time on measured trials, extrapolate over the untried
        grid, measure the predicted best, refit — until the model's argmax
        is already measured or the trial budget runs out."""
        c = self.config
        candidates = [ov for sweep in self.sweeps() for ov in sweep]
        seqs = sorted({ov.get("_seq_len") for ov in candidates
                       if ov.get("_seq_len")} or {1})
        space = {
            "stages": sorted({ov["zero_optimization"]["stage"]
                              for ov in candidates}),
            "remats": sorted({ov.get("_remat_policy") for ov in candidates},
                             key=str),
            "attns": sorted({ov.get("_attn_impl") for ov in candidates},
                            key=str),
            "offloads": sorted(
                {(ov["zero_optimization"].get("offload_optimizer") or {}
                  ).get("device") for ov in candidates}, key=str),
            "pps": sorted({ov.get("_pp") for ov in candidates}, key=str),
            "seq_default": float(seqs[0]),
            "seq_scale": float(max(seqs)),
        }
        # profiler-informed feature scaling: the S·mb (dense) and S²·mb
        # (attention) features carry the MODEL'S measured per-token flop
        # coefficients (flops_profiler per-module breakdown) instead of
        # unit weights — the ridge fit then starts from physically-scaled
        # regressors and needs fewer seed trials to separate the two terms
        try:
            from ..profiling.flops_profiler import get_detailed_profile

            det = get_detailed_profile(self.model, batch_size=1,
                                       seq_len=int(space["seq_default"]),
                                       device=self.device)
            tot = det["total"]["flops_per_token"] or 1.0
            space["dense_coeff"] = det["dense_flops_per_token"] / tot
            space["attn_coeff"] = det["attn_flops_per_token"] / tot
        except Exception:
            pass
        key = lambda ov: json.dumps(ov, sort_keys=True)  # noqa: E731
        measured: Dict[str, TrialRecord] = {}
        best: Optional[TrialRecord] = None

        # features that never vary over THIS grid carry no signal — prune
        # them so small grids stay well-determined under the rich set; then
        # normalize columns (unit scale over the grid) so the ridge fit and
        # the exploration geometry aren't dominated by mb² >> Sn-scale terms
        X_all = np.stack([self._features(ov, space) for ov in candidates])
        keep_cols = np.ptp(X_all, axis=0) > 0
        keep_cols[0] = True                     # intercept
        Xk = X_all[:, keep_cols]
        col_scale = np.maximum(np.abs(Xk).max(axis=0), 1e-12)
        feat_of = {key(ov): Xk[i] / col_scale
                   for i, ov in enumerate(candidates)}
        n_feat = int(keep_cols.sum())

        def measure(ov) -> TrialRecord:
            nonlocal best
            rec = self._measure(ov)
            self.records.append(rec)
            measured[key(ov)] = rec
            log_dist(f"autotuning[model] trial {ov}: {rec.status} "
                     f"metric={rec.metric_val:.2f}", ranks=[0])
            if rec.status == "ok" and (best is None
                                       or rec.metric_val > best.metric_val):
                best = rec
            return rec

        # seed: spread over the micro-batch range of the first sweep(s)
        seeds = candidates[:: max(1, len(candidates) // max(c.seed_trials, 1))]
        for ov in seeds[:c.seed_trials]:
            measure(ov)

        while len(self.records) < c.max_trials:
            ok = [r for r in measured.values() if r.status == "ok"]
            if len(ok) < 2:
                # not enough signal to fit — fall back to the next untried
                untried = [ov for ov in candidates if key(ov) not in measured]
                if not untried:
                    break
                measure(untried[0])
                continue
            X = np.stack([feat_of[key(r.config_overrides)] for r in ok])
            # fit per-sample step time: t = batch / throughput
            t = np.asarray([
                r.config_overrides["train_micro_batch_size_per_gpu"]
                * r.config_overrides.get("gradient_accumulation_steps", 1)
                / max(r.metric_val, 1e-9) if c.metric == "throughput"
                else -r.metric_val for r in ok])
            coef = self._ridge_fit(X, t)
            oom_keys = {key(r.config_overrides) for r in measured.values()
                        if r.status != "ok"}
            scored = []
            for ov in candidates:
                if key(ov) in oom_keys:
                    continue
                t_hat = float(feat_of[key(ov)] @ coef)
                samples = (ov["train_micro_batch_size_per_gpu"]
                           * ov.get("gradient_accumulation_steps", 1))
                if c.metric == "throughput":
                    score = samples / max(t_hat, 1e-9) if t_hat > 0 else 0.0
                else:  # latency: smallest predicted step time wins
                    score = -t_hat
                scored.append((score, ov))
            scored.sort(key=lambda p: -p[0])
            if not scored:
                break
            if key(scored[0][1]) not in measured:
                measure(scored[0][1])
                continue
            # the model's argmax is already measured: converged only when
            # the fit is determined; otherwise EXPLORE — measure the
            # unmeasured candidate whose feature vector lies furthest out of
            # the measured span (D-optimal-flavored), which buys the fit the
            # most new information per trial on a big grid
            if len(ok) >= n_feat:
                break
            Q, _ = np.linalg.qr(X.T)

            def novelty(ov):
                x = feat_of[key(ov)]
                r = x - Q @ (Q.T @ x)
                return float(np.dot(r, r))

            untried = [ov for _, ov in scored if key(ov) not in measured]
            if not untried:
                break
            measure(max(untried, key=novelty))
        return best

    # -- one trial --
    def _budget(self) -> int:
        return (self.config.hbm_bytes if self.config.hbm_bytes is not None
                else device_memory_bytes())

    def _trial(self, rec: TrialRecord, overrides: Dict[str, Any], warm: int,
               steps: int, error_status: str = "run_error") -> None:
        """Build the engine, run ``warm`` steps from a reset peak (the
        peak is the trial's ``memory_bytes``), then time ``steps`` more
        between device synchronisations; free the engine either way."""
        import gc

        import torch

        cuda = torch.cuda.is_available()
        engine = batch = None
        try:
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            engine = self.make_engine(dict(overrides))
            batch = self.make_batch(engine)
            for _ in range(warm):
                loss = engine.train_batch(batch=batch)
            if warm:
                float(loss)
            rec.compile_sec = time.perf_counter() - t0
            if not _apply_budget(rec, torch.cuda.max_memory_allocated() if cuda else None,
                                 self._budget()):
                return
            if steps:
                if cuda:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(steps):
                    loss = engine.train_batch(batch=batch)
                float(loss)
                if cuda:
                    torch.cuda.synchronize()
                dt = (time.perf_counter() - t0) / steps
                samples = engine.train_batch_size
                rec.metric_val = (samples / dt if self.config.metric == "throughput"
                                  else -dt)
        except torch.OutOfMemoryError as e:
            rec.status = "compile_oom"
            rec.error = str(e)[:300]
        except Exception as e:  # noqa: BLE001 — a failed trial is a record
            msg = str(e)
            rec.status = ("compile_oom" if "out of memory" in msg.lower()
                          else error_status)
            rec.error = msg[:300]
        finally:
            del engine, batch
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()

    def _measure(self, overrides: Dict[str, Any]) -> TrialRecord:
        rec = TrialRecord(config_overrides=overrides, status="ok")
        # timed steps (start/end_profile_step warmup convention)
        warm = self.config.start_profile_step
        steps = max(1, self.config.end_profile_step - warm)
        self._trial(rec, overrides, warm, steps)
        return rec

    def tune(self) -> Tuple[Optional[Dict[str, Any]], List[TrialRecord]]:
        """Run the search; returns (best_overrides, records) and writes
        ``results_dir/`` like the reference (per-trial records + best)."""
        if not self.config.enabled:
            raise ValueError("autotuning is not enabled in the config")
        if self.config.tuner_type == "model_based":
            best = self._tune_model_based()
            self._write_results(best)
            return (best.config_overrides if best else None), self.records
        best: Optional[TrialRecord] = None
        trials = 0
        for sweep in self.sweeps():
            prev_val = -float("inf")
            for overrides in sweep:
                if trials >= self.config.max_trials:
                    break
                rec = self._measure(overrides)
                trials += 1
                self.records.append(rec)
                log_dist(f"autotuning trial {overrides}: {rec.status} "
                         f"metric={rec.metric_val:.2f} "
                         f"mem={rec.memory_bytes / 1e9:.2f}GB", ranks=[0])
                if rec.status == "ok" and (best is None
                                           or rec.metric_val > best.metric_val):
                    best = rec
                if self.config.fast:
                    if rec.status == "compile_oom":
                        break   # larger micro-batches in this sweep also OOM
                    if rec.status == "ok" and rec.metric_val < prev_val:
                        break   # past this sweep's throughput peak
                    if rec.status == "ok":
                        prev_val = rec.metric_val
            if trials >= self.config.max_trials:
                break
        self._write_results(best)
        return (best.config_overrides if best else None), self.records

    def _write_results(self, best: Optional[TrialRecord]) -> None:
        d = self.config.results_dir
        if os.path.isdir(d) and os.listdir(d) and not self.config.overwrite:
            raise FileExistsError(
                f"results_dir {d} exists and autotuning.overwrite is false")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "records.json"), "w") as f:
            json.dump([r.as_dict() for r in self.records], f, indent=2)
        if best is not None:
            with open(os.path.join(d, "best_config.json"), "w") as f:
                json.dump({"overrides": best.config_overrides,
                           "metric": self.config.metric,
                           "metric_val": best.metric_val}, f, indent=2)
        logger.info(f"autotuning: {len(self.records)} trials -> {d}")


def autotune(model_factory: Callable[[], Any], base_config: Dict[str, Any],
             batch_factory: Callable[[Any], Any],
             autotuning_config: Optional[Dict] = None, device=None):
    """Convenience entry (reference ``deepspeed --autotuning run``): search
    around ``base_config`` and return (best_full_config, records).  The
    engines run on ``device`` (the card unless the caller names the
    CPU)."""
    import deepspeed_tpu_torch

    at_cfg = AutotuningConfig.from_dict(
        autotuning_config or base_config.get("autotuning"))

    def make_engine(overrides):
        cfg = json.loads(json.dumps({k: v for k, v in base_config.items()
                                     if k != "autotuning"}))
        remat = overrides.pop("_remat_policy", None)
        attn = overrides.pop("_attn_impl", None)
        seq = overrides.pop("_seq_len", None)
        pp = overrides.pop("_pp", None)
        for k, v in overrides.items():
            if isinstance(v, dict):
                cfg.setdefault(k, {}).update(v)
            else:
                cfg[k] = v
        if pp is not None:
            cfg.setdefault("mesh", {})["pp"] = pp
        model = model_factory()
        model_over = {}
        if remat is not None:
            model_over["remat_policy"] = remat
        if seq is not None:
            # seq-len trials: the model's window shrinks/grows; the batch
            # factory reads engine.autotune_seq_len to size the batch
            model_over["max_seq_len"] = seq
        if pp is not None:
            model_over["pipeline_stages"] = pp
        if model_over and hasattr(model, "config"):
            model.config = dataclasses.replace(model.config, **model_over)
        if attn is not None and hasattr(model, "attn_impl"):
            model.attn_impl = attn
        engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config=cfg,
                                                         device=device)
        engine.autotune_seq_len = seq
        return engine
    try:
        profile_model = model_factory()
    except Exception:
        profile_model = None
    tuner = Autotuner(make_engine, batch_factory, at_cfg,
                      model=profile_model, device=device)
    best, records = tuner.tune()
    full = None
    if best is not None:
        full = json.loads(json.dumps({k: v for k, v in base_config.items()
                                      if k != "autotuning"}))
        for k, v in best.items():
            if isinstance(v, dict):
                full.setdefault(k, {}).update(v)
            elif k == "_pp":
                # a pipeline winner needs BOTH the engine mesh degree and
                # the model's pipeline_stages; mesh.pp is an engine key we
                # can set here, the model half rides along like _remat_policy
                full.setdefault("mesh", {})["pp"] = v
                full[k] = v
            else:
                # "_remat_policy"/"_seq_len" ride along: they are MODEL
                # overrides the caller must apply (TransformerConfig), not
                # engine-config keys — dropping them would return a config
                # that does not reproduce the measured winner
                full[k] = v
    return full, records
