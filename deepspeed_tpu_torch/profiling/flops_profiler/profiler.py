"""Flops profiler (counterpart of
``deepspeed_tpu/profiling/flops_profiler/profiler.py``; reference
``deepspeed/profiling/flops_profiler/profiler.py:24``).

The JAX package asks XLA for the compiled program's cost.  PyTorch has no
compiled program to ask, so the port counts what is executed:

- **flops**: ``torch.utils.flop_counter.FlopCounterMode`` over the run —
  ``2*M*K*N`` for every matmul (and convolution and SDPA) dispatched, the
  backward's and a remat recompute's included; elementwise operations
  count nothing, as in torch's counter.  The flash-attention kernels launch
  through ctypes, where the dispatcher cannot see them, so each launch
  adds its own count (``ops/kernels/flash_attention.py`` ``kernel_cost``:
  ``GEMMS[kernel] * 2 * B * Hq * attended_pairs * hd``, the forward 2
  products, K2 3, K3 4) through ``ops/kernels/common.py``'s
  ``cost_sinks``.
- **bytes accessed**: no compiler reports them here, so the profiler sums,
  for every dispatched operation that is not a view, the bytes of its
  tensor inputs and outputs (an in-place operation's tensor counts as read
  and written), plus each kernel launch's inputs read once and outputs
  written once.  Every operation's traffic is counted as if it went to
  memory: an upper bound of what the device moves (the caching allocator
  and the L2 keep some of it on chip).

Two surfaces, the JAX package's: ``get_model_profile`` (a model's
forward) and ``FlopsProfiler`` (the engine's step at ``profile_step``).
The JAX package profiles an unrolled copy of a scanned model; the port's
layers run in a Python loop, so every layer is counted as it is.
"""
from __future__ import annotations

import contextlib
import json
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ...utils.logging import logger
from ...utils.tree import tree_leaves


def _number(x: float, units: Optional[str] = None, precision: int = 2) -> str:
    if units is None:
        if x >= 1e12:
            return f"{x / 1e12:.{precision}f} T"
        if x >= 1e9:
            return f"{x / 1e9:.{precision}f} G"
        if x >= 1e6:
            return f"{x / 1e6:.{precision}f} M"
        if x >= 1e3:
            return f"{x / 1e3:.{precision}f} K"
        return f"{x:.{precision}f}"
    return f"{x:.{precision}f} {units}"


number_to_string = _number  # reference naming (profiler.py:927)


def flops_to_string(flops, units=None, precision=2):
    return _number(flops, units, precision) + ("FLOPS" if units is None else "")


def params_to_string(n, units=None, precision=2):
    return _number(n, units, precision)


def macs_to_string(n, units=None, precision=2):
    return _number(n, units, precision) + ("MACs" if units is None else "")


def _is_view(func) -> bool:
    """An operation whose outputs alias its inputs without writing them (a
    view moves no bytes)."""
    schema = func._schema
    return (any(r.alias_info is not None for r in schema.returns)
            and not any(a.alias_info is not None and a.alias_info.is_write
                        for a in schema.arguments))


class _ByteCounter(TorchDispatchMode):
    """Sums the bytes of the tensor inputs and outputs of every dispatched
    operation that is not a view."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not _is_view(func):
            flat = tree_flatten((args, kwargs or {}))[0] + tree_flatten(out)[0]
            self.bytes += sum(t.numel() * t.element_size() for t in flat
                              if isinstance(t, torch.Tensor))
        return out


class CostCounter:
    """A context that counts the flops and bytes of what runs inside it
    (see the module docstring); ``cost()`` gives the JAX package's keys,
    ``flops`` and ``bytes accessed``, and the kernels' share apart."""

    def __init__(self):
        from torch.utils.flop_counter import FlopCounterMode

        self._flops = FlopCounterMode(display=False)
        self._bytes = _ByteCounter()
        self.kernel_flops = 0.0
        self.kernel_bytes = 0.0
        self.kernel_launches: Dict[str, int] = {}
        self._stack: Optional[contextlib.ExitStack] = None

    def _sink(self, kernel: str, flops: float, nbytes: float) -> None:
        self.kernel_flops += flops
        self.kernel_bytes += nbytes
        self.kernel_launches[kernel] = self.kernel_launches.get(kernel, 0) + 1

    def __enter__(self):
        from ...ops.kernels.common import cost_sinks

        self._stack = contextlib.ExitStack()
        self._stack.enter_context(self._flops)
        self._stack.enter_context(self._bytes)
        cost_sinks.append(self._sink)
        self._stack.callback(cost_sinks.remove, self._sink)
        return self

    def __exit__(self, *exc):
        stack, self._stack = self._stack, None
        return stack.__exit__(*exc)

    def cost(self) -> Dict[str, Any]:
        by_op = {str(k): float(v) for k, v in
                 self._flops.get_flop_counts().get("Global", {}).items()}
        dispatched = float(self._flops.get_total_flops())
        return {"flops": dispatched + self.kernel_flops,
                "bytes accessed": float(self._bytes.bytes) + self.kernel_bytes,
                "dispatched_flops": dispatched, "kernel_flops": self.kernel_flops,
                "kernel_bytes": self.kernel_bytes,
                "kernel_launches": dict(self.kernel_launches), "flops_by_op": by_op}


def cost_analysis_of(fn, *args, **kwargs) -> Dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` once and count its costs: at least
    ``flops`` and ``bytes accessed`` (the JAX package's keys; see the
    module docstring for what each counts).  Unlike XLA's analysis this
    executes ``fn``; the result's ``output`` holds what it returned."""
    with CostCounter() as counter:
        out = fn(*args, **kwargs)
    return {**counter.cost(), "output": out}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _param_count(params) -> int:
    return sum(x.numel() for x in tree_leaves(params) if hasattr(x, "numel"))


def _model_inputs(model, batch_size: int, seq_len: int, device):
    """The model's params (its init, in its compute dtype) and seeded
    tokens, as the JAX package profiles them."""
    cfg = model.config
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = model.init_fn(gen, device=device, dtype=getattr(cfg, "dtype", torch.float32))
    vocab = getattr(cfg, "vocab_size", 1000)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, vocab, (batch_size, seq_len)).astype(np.int64)).to(device)
    return params, tokens


def get_model_profile(model, batch_size: int = 1, seq_len: int = 128,
                      warm_up: int = 1, as_string: bool = True,
                      print_profile: bool = True, detailed: bool = True,
                      output_file: Optional[str] = None, device=None):
    """Profile a model's forward (reference ``get_model_profile``).

    ``model`` has ``init_fn``/``apply_fn`` (``models.CausalLM``); its
    weights are its init on ``device`` (the card unless the caller names
    the CPU).  Returns ``(flops, macs, params)`` — strings when
    ``as_string``, numbers otherwise."""
    from ...accelerator import resolve_device

    device = resolve_device(device)
    params, tokens = _model_inputs(model, batch_size, seq_len, device)
    with torch.no_grad():
        ca = cost_analysis_of(model.apply_fn, params, tokens)
        flops = float(ca["flops"])
        macs = flops / 2.0
        nparams = _param_count(params)
        latency = None
        if warm_up >= 0:
            for _ in range(max(warm_up, 1)):
                model.apply_fn(params, tokens)
            _sync(device)
            t0 = time.perf_counter()
            model.apply_fn(params, tokens)
            _sync(device)
            latency = time.perf_counter() - t0

    if print_profile:
        lines = ["-" * 72,
                 "DeepSpeed-TPU Flops Profiler — model forward",
                 "-" * 72,
                 f"params:                 {params_to_string(nparams)}",
                 f"batch x seq:            {batch_size} x {seq_len}",
                 f"fwd flops (counted):    {flops_to_string(flops)}",
                 f"fwd MACs:               {macs_to_string(macs)}",
                 f"fwd flops per token:    {_number(flops / (batch_size * seq_len))}"]
        if latency:
            lines.append(f"fwd latency:            {latency * 1e3:.2f} ms")
            lines.append(f"fwd TFLOPS achieved:    {flops / latency / 1e12:.2f}")
        if detailed:
            ba = ca.get("bytes accessed", None)
            if ba:
                lines.append(f"bytes accessed (ops):   {_number(float(ba))}B")
                lines.append(f"arithmetic intensity:   {flops / float(ba):.1f} flop/B")
        lines.append("-" * 72)
        if detailed:
            try:
                det = get_detailed_profile(model, batch_size, seq_len, device=device)
                lines.append(f"{'module':<38}{'count':>6}{'flops':>12}{'%':>7}")
                for r in det["modules"]:
                    lines.append(f"{r['name']:<38}{r['count']:>6}"
                                 f"{_number(r['flops']):>12}{r['pct']:>6.1f}%")
                lines.append("-" * 72)
            except Exception as e:  # het/MoE configs may lack a block slice
                lines.append(f"(per-module breakdown unavailable: {e})")
        report = "\n".join(lines)
        if output_file:
            with open(output_file, "w") as f:
                f.write(report + "\n")
        else:
            logger.info("\n" + report)

    if as_string:
        return flops_to_string(flops), macs_to_string(macs), params_to_string(nparams)
    return flops, macs, nparams


def get_detailed_profile(model, batch_size: int = 1, seq_len: int = 128,
                         print_profile: bool = False, device=None):
    """Per-module breakdown (reference ``FlopsProfiler`` module tree):
    the counts of the building blocks the model's forward composes — the
    embedding, one layer's attention core, one layer's MLP, one whole
    layer, the head (the embedding's transpose when tied) — and the rest
    (projections and norms, final norm and residuals) as remainders of the
    whole forward.

    Attention is pinned to the plain branch (``"xla"``), as the JAX
    package pins its XLA path: the rows then count the same products at
    every length.  Returns ``{"total": {...}, "modules": [row, ...]}``,
    each row ``name / flops / bytes / pct / count`` (count = L for
    per-layer rows), and ``dense_flops_per_token`` /
    ``attn_flops_per_token`` (the autotuner's cost-model features)."""
    import copy

    from ...accelerator import resolve_device
    from ...models import transformer as T

    device = resolve_device(device)
    cfg = model.config
    if getattr(model, "attn_impl", "xla") != "xla":
        model = copy.copy(model)   # never mutate the caller's model
        model.attn_impl = "xla"
    params, tokens = _model_inputs(model, batch_size, seq_len, device)
    layers = params["layers"]
    lp0 = {k: v[0] for k, v in layers.items()}
    L = cfg.num_layers
    B, S, d = batch_size, seq_len, cfg.hidden_size
    hd, nh, nkv = cfg.dims_per_head, cfg.num_heads, cfg.kv_heads
    dtype = getattr(cfg, "dtype", torch.float32)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    positions = torch.arange(S, device=device).expand(B, S)
    x = torch.randn((B, S, d), generator=gen, device=device).to(dtype)
    q = torch.randn((B, S, nh, hd), generator=gen, device=device).to(dtype)
    kv = torch.randn((B, S, nkv, hd), generator=gen, device=device).to(dtype)

    def _flops_bytes(fn, *args):
        ca = cost_analysis_of(fn, *args)
        return float(ca["flops"]), float(ca["bytes accessed"])

    rows = []

    def add(name, fl, by, count=1):
        rows.append({"name": name, "flops": fl * count, "bytes": by * count,
                     "count": count})

    with torch.no_grad():
        emb_f, emb_b = _flops_bytes(lambda e, t: e[t], params["embed"], tokens)
        add("embed", emb_f, emb_b)
        attn_f, attn_b = _flops_bytes(
            lambda q, k, v: T._attention(cfg, q, k, v, positions, "xla"), q, kv, kv)
        mlp_f, mlp_b = _flops_bytes(lambda lp, h: T._mlp(cfg, lp, h), lp0, x)
        blk_f, blk_b = _flops_bytes(
            lambda lp, h: T._block(cfg, lp, h, positions, "xla"), lp0, x)
        add("layer.attention_core", attn_f, attn_b, count=L)
        add("layer.qkv_out_projections+norms", max(blk_f - attn_f - mlp_f, 0.0),
            max(blk_b - attn_b - mlp_b, 0.0), count=L)
        add("layer.mlp", mlp_f, mlp_b, count=L)
        head_w = params["lm_head"] if "lm_head" in params else params["embed"].t()
        head_f, head_b = _flops_bytes(lambda w, h: h @ w, head_w, x)
        add("lm_head", head_f, head_b)
        total_f, total_b = _flops_bytes(model.apply_fn, params, tokens)
    accounted_f = sum(r["flops"] for r in rows)
    accounted_b = sum(r["bytes"] for r in rows)
    add("other (final norm, residuals, loss)",
        max(total_f - accounted_f, 0.0), max(total_b - accounted_b, 0.0))
    for r in rows:
        r["pct"] = round(100.0 * r["flops"] / total_f, 1) if total_f else 0.0

    ntok = B * S
    out = {
        "total": {"flops": total_f, "bytes": total_b,
                  "flops_per_token": total_f / ntok},
        "modules": rows,
        "dense_flops_per_token": max(total_f - attn_f * L, 0.0) / ntok,
        "attn_flops_per_token": attn_f * L / ntok,
        "batch_size": B, "seq_len": S,
    }
    if print_profile:
        lines = ["-" * 72,
                 "DeepSpeed-TPU Flops Profiler — per-module breakdown "
                 f"(B={B}, S={S})",
                 "-" * 72,
                 f"{'module':<38}{'count':>6}{'flops':>12}{'bytes':>12}{'%':>6}"]
        for r in rows:
            lines.append(f"{r['name']:<38}{r['count']:>6}"
                         f"{_number(r['flops']):>12}"
                         f"{_number(r['bytes']):>12}B{r['pct']:>5.1f}")
        lines.append(f"{'TOTAL (forward)':<38}{'':>6}"
                     f"{_number(total_f):>12}{_number(total_b):>12}B{100.0:>5.1f}")
        lines.append("-" * 72)
        logger.info("\n" + "\n".join(lines))
    return out


class FlopsProfiler:
    """Engine-attached profiler (reference ``FlopsProfiler`` class).

    The engine calls ``start_profile()`` / ``stop_profile()`` around the
    configured ``profile_step`` and ``print_model_profile()`` after it:
    the step runs inside a :class:`CostCounter`, timed between two device
    synchronisations (the counting's host work included; a step that keeps
    the device busy hides it)."""

    def __init__(self, engine=None, config=None):
        self.engine = engine
        self.config = config
        self.started = False
        self._t0 = None
        self._latency = None
        self._counter: Optional[CostCounter] = None
        self._cost: Dict[str, Any] = {}

    def _device(self):
        return getattr(self.engine, "device", torch.device("cpu"))

    # -- lifecycle -------------------------------------------------------
    def start_profile(self, ignore_list=None) -> None:
        _sync(self._device())
        self._counter = CostCounter().__enter__()
        self.started = True
        self._t0 = time.perf_counter()

    def stop_profile(self) -> None:
        if self._counter is not None:
            _sync(self._device())
            if self._t0 is not None:
                self._latency = time.perf_counter() - self._t0
            self._counter.__exit__(None, None, None)
            self.attach_cost(self._counter.cost())
            self._counter = None
        self.started = False

    def end_profile(self) -> None:  # reference alias
        self.stop_profile()

    def attach_cost(self, cost: Dict[str, Any]) -> None:
        self._cost = {k: v for k, v in dict(cost or {}).items() if k != "output"}

    # -- accessors (reference API) --------------------------------------
    def get_total_flops(self, as_string: bool = False):
        f = float(self._cost.get("flops", 0.0))
        return flops_to_string(f) if as_string else f

    def get_total_macs(self, as_string: bool = False):
        m = float(self._cost.get("flops", 0.0)) / 2.0
        return macs_to_string(m) if as_string else m

    def get_total_params(self, as_string: bool = False):
        n = int(getattr(self.engine, "param_count", 0) or 0)
        return params_to_string(n) if as_string else n

    def get_total_duration(self, as_string: bool = False):
        d = self._latency or 0.0
        return f"{d * 1e3:.2f} ms" if as_string else d

    # -- report ----------------------------------------------------------
    def print_model_profile(self, profile_step: int = 1, module_depth: int = -1,
                            top_modules: int = 1, detailed: bool = True,
                            output_file: Optional[str] = None) -> None:
        flops = self.get_total_flops()
        dur = self.get_total_duration()
        lines = ["-" * 72,
                 f"DeepSpeed-TPU Flops Profiler — train step @ step {profile_step}",
                 "-" * 72,
                 f"params:                       {self.get_total_params(True)}",
                 f"flops per step (counted):     {flops_to_string(flops)}",
                 f"MACs per step:                {self.get_total_macs(True)}"]
        if dur:
            lines.append(f"step latency:                 {dur * 1e3:.2f} ms")
            lines.append(f"TFLOPS achieved:              {flops / dur / 1e12:.2f}")
        if detailed:
            ba = self._cost.get("bytes accessed")
            if ba:
                lines.append(f"bytes accessed (ops):         {_number(float(ba))}B")
                lines.append(f"arithmetic intensity:         "
                             f"{flops / float(ba):.1f} flop/B")
            kf = self._cost.get("kernel_flops")
            if kf:
                lines.append(f"attention kernels' flops:     {flops_to_string(kf)} "
                             f"({self._cost.get('kernel_launches')})")
            eng = self.engine
            cfg = getattr(getattr(eng, "model", None), "config", None)
            if cfg is not None and hasattr(cfg, "param_count"):
                try:
                    bsz = eng.micro_batch_size * eng.gas
                    S = cfg.max_seq_len
                    dense = 6.0 * cfg.param_count * bsz * S
                    attn = 12.0 * cfg.num_layers * cfg.hidden_size * S * bsz * S
                    lines.append(f"analytic model flops (6N+12LdS): "
                                 f"{flops_to_string(dense + attn)} "
                                 f"(dense {100 * dense / (dense + attn):.0f}% / "
                                 f"attn {100 * attn / (dense + attn):.0f}%)")
                except Exception:
                    pass
        lines.append("-" * 72)
        report = "\n".join(lines)
        if output_file:
            with open(output_file, "w") as f:
                f.write(report + "\n")
        else:
            logger.info("\n" + report)

    def as_dict(self) -> Dict[str, Any]:
        return {"flops": self.get_total_flops(), "macs": self.get_total_macs(),
                "params": self.get_total_params(), "duration_s": self.get_total_duration(),
                **{k: v for k, v in self._cost.items() if isinstance(v, (int, float))}}

    def to_json(self) -> str:
        return json.dumps(self.as_dict())
