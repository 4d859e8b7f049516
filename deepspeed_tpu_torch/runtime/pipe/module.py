"""PipelineModule / LayerSpec (counterpart of
``deepspeed_tpu/runtime/pipe/module.py``; reference ``runtime/pipe/module.py:85``).

The same authoring surface as the JAX package: a list of layer specs, a
partitioner ("parameters" or "uniform" balancing), tied layers, and a full
model the engine trains (``deepspeed_tpu_torch.initialize(model=pm)``).

- Layer contract: ``spec.build()`` returns an object with ``init(generator)
  -> params`` and ``apply(params, x) -> x`` (or ``(x, aux)``), such as
  ``moe.MoE``; or an ``nn.Module``, whose parameters are its params and
  which runs through ``torch.func.functional_call``; or a parameterless
  callable.
- ``num_stages == 1``: the layers compose in order; tied layers share one
  entry of ``params['tied']`` (a ``TiedLayerSpec`` with ``forward_fn``
  applies it its own way, e.g. the embedding transposed as the head).
- ``num_stages > 1``: each stage is an ``nn.Module`` of its layers
  (:meth:`stage_module`), and the tree is the JAX package's: one leaf a
  layer position, stacked ``[P, ...]`` over the stages (``params['stages']``),
  whose stage dim rides 'pipe' (``param_specs``).  The JAX package
  requires structurally identical stages (one SPMD program runs them all)
  and no ties across stages; the port keeps its refusals and messages so
  the two trees stay one format.  Training runs the stages through the
  executor (:meth:`pipeline_backward`); activations between stages keep
  the inputs' shape and dtype, as identical stages give.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn


class LayerSpec:
    """Deferred layer construction (reference module.py:29)."""

    def __init__(self, typename: Callable, *args, **kwargs):
        self.typename = typename
        self.args = args
        self.kwargs = kwargs

    def build(self):
        return self.typename(*self.args, **self.kwargs)

    def __repr__(self):
        return f"LayerSpec({getattr(self.typename, '__name__', self.typename)})"


class TiedLayerSpec(LayerSpec):
    """Layers sharing parameters (reference module.py:76), e.g. tied input
    and output embeddings; ``key`` groups the specs."""

    def __init__(self, key: str, typename: Callable, *args,
                 forward_fn: Optional[Callable] = None, **kwargs):
        super().__init__(typename, *args, **kwargs)
        self.key = key
        self.forward_fn = forward_fn


def partition_balanced(weights: Sequence[float], num_parts: int) -> List[int]:
    """Split ``weights`` into ``num_parts`` contiguous chunks minimising the
    heaviest (the reference's ds_utils.partition_balanced): part
    boundaries, ``num_parts + 1`` of them."""
    n = len(weights)
    if num_parts > n:
        raise ValueError(f"cannot split {n} layers into {num_parts} stages")
    prefix = np.concatenate([[0.0], np.cumsum(weights)])
    INF = float("inf")
    dp = np.full((num_parts + 1, n + 1), INF)
    cut = np.zeros((num_parts + 1, n + 1), dtype=int)
    dp[0][0] = 0.0
    for p in range(1, num_parts + 1):
        for i in range(p, n + 1):
            for j in range(p - 1, i):
                cost = max(dp[p - 1][j], prefix[i] - prefix[j])
                if cost < dp[p][i]:
                    dp[p][i] = cost
                    cut[p][i] = j
    bounds = [n]
    for p in range(num_parts, 0, -1):
        bounds.append(cut[p][bounds[-1]])
    return list(reversed(bounds))


@dataclasses.dataclass(frozen=True)
class _PipeModuleConfig:
    pipeline_stages: int
    pipeline_microbatches: int


@dataclasses.dataclass(frozen=True)
class _TiedRef:
    """Placeholder entry pointing a tied layer at its shared parameters."""
    key: str


def _layer_init(layer, generator, device):
    if hasattr(layer, "init"):
        return layer.init(generator)
    if isinstance(layer, nn.Module):
        return {n: p.detach().to(device).clone() for n, p in layer.named_parameters()}
    return {}                                   # a parameterless callable


def _apply(layer, p, x):
    """Layer call normaliser: returns (x, aux or None)."""
    if hasattr(layer, "init") and hasattr(layer, "apply"):   # the functional contract
        out = layer.apply(p, x)
    elif isinstance(layer, nn.Module):
        out = torch.func.functional_call(layer, p, (x,))
    else:
        out = layer(x)
    if isinstance(out, tuple):
        return out[0], out[1]
    return out, None


class _Stage(nn.Module):
    """One stage's layers as a module over a given stage tree."""

    def __init__(self, layers: List[Any]):
        super().__init__()
        self.layers = layers

    def forward(self, params: List[Any], x):
        aux = None
        for layer, p in zip(self.layers, params):
            x, a = _apply(layer, p, x)
            if a is not None:
                aux = a if aux is None else aux + a
        return x, aux


class PipelineModule(nn.Module):
    """Authoring surface for layer-list pipelines (the transformer family's
    own path is ``TransformerConfig.pipeline_stages``)."""

    def __init__(self, layers: Sequence[LayerSpec], num_stages: int,
                 partition_method: str = "parameters",
                 loss_fn: Optional[Callable] = None,
                 microbatches: Optional[int] = None):
        super().__init__()
        self.layer_specs = list(layers)
        self.num_stages = num_stages
        self.partition_method = partition_method
        # the training loss head, loss_fn(outputs, batch) -> scalar (named
        # loss_fn in the constructor for the reference's signature)
        self.loss_head = loss_fn
        self._microbatches = microbatches
        self.parts = self._partition()

    def _layer_weights(self) -> List[float]:
        if self.partition_method == "uniform":
            return [1.0] * len(self.layer_specs)
        if self.partition_method == "parameters":
            weights = []
            for spec in self.layer_specs:
                built = spec.build() if isinstance(spec, LayerSpec) else spec
                count = getattr(built, "param_count", None)
                if count is None and isinstance(built, nn.Module):
                    count = sum(p.numel() for p in built.parameters())
                weights.append(float(count) if count is not None else 1.0)
            return weights
        raise ValueError(f"unknown partition_method {self.partition_method}")

    def _partition(self) -> List[int]:
        return partition_balanced(self._layer_weights(), self.num_stages)

    def stage_layers(self, stage_id: int) -> List[LayerSpec]:
        lo, hi = self.parts[stage_id], self.parts[stage_id + 1]
        return self.layer_specs[lo:hi]

    def stage_of_layer(self, layer_idx: int) -> int:
        for s in range(self.num_stages):
            if self.parts[s] <= layer_idx < self.parts[s + 1]:
                return s
        raise IndexError(layer_idx)

    def tied_keys(self) -> Dict[str, List[int]]:
        tied: Dict[str, List[int]] = {}
        for i, spec in enumerate(self.layer_specs):
            if isinstance(spec, TiedLayerSpec):
                tied.setdefault(spec.key, []).append(i)
        return tied

    @property
    def config(self):
        micro = self._microbatches or self.num_stages
        return _PipeModuleConfig(pipeline_stages=self.num_stages,
                                 pipeline_microbatches=micro)

    def _built(self) -> List[Any]:
        if not hasattr(self, "_built_layers"):
            self._built_layers = [spec.build() if isinstance(spec, LayerSpec) else spec
                                  for spec in self.layer_specs]
        return self._built_layers

    def stage_module(self, stage_id: int) -> nn.Module:
        """Stage ``stage_id``'s layers as an ``nn.Module``
        (``forward(stage_params, x) -> (x, aux)``)."""
        lo, hi = self.parts[stage_id], self.parts[stage_id + 1]
        return _Stage(self._built()[lo:hi])

    def _uniform_stage_shape(self, inits) -> None:
        """num_stages > 1: every stage identical in structure (the JAX
        package's precondition and messages)."""
        counts = {self.parts[s + 1] - self.parts[s] for s in range(self.num_stages)}
        if self.tied_keys() and self.num_stages > 1:
            raise ValueError(
                "TiedLayerSpec is not supported on the SPMD pipeline path: "
                "one stage program is vmapped over all stages, so "
                "cross-stage parameter sharing has no home.  Keep tied "
                "embeddings/heads outside the pipelined body (see "
                "models/transformer.py) or use num_stages=1.")
        if len(counts) != 1:
            raise ValueError(
                f"SPMD pipelining needs structurally identical stages; "
                f"partition {self.parts} gives unequal layer counts "
                f"{sorted(counts)}.  Use partition_method='uniform' with a "
                f"layer count divisible by num_stages.")
        lp = counts.pop()
        ref = inits[:lp]
        for s in range(1, self.num_stages):
            seg = inits[s * lp:(s + 1) * lp]
            same = all(
                isinstance(a, dict) and isinstance(b, dict) and sorted(a) == sorted(b)
                and all(a[k].shape == b[k].shape and a[k].dtype == b[k].dtype for k in a)
                for a, b in zip(seg, ref))
            if not same:
                raise ValueError(
                    f"SPMD pipelining needs structurally identical stages; "
                    f"stage {s} differs from stage 0 in param treedef/shapes.")

    def init_fn(self, generator: Optional[torch.Generator] = None, device=None,
                tp=None, cuts=None, dtype=None):
        """The layers' parameters from ``generator`` (stacked ``[P, ...]``
        over the stages when ``num_stages > 1``); ``cuts`` keeps this
        rank's stages of a 'pipe' axis.  Inside an active ``OnDevice``
        the context's device and dtype apply."""
        from ...utils.init_on_device import on_device_init

        return on_device_init(self._init_impl)(generator, device=device, tp=tp,
                                               cuts=cuts, dtype=dtype)

    def _init_impl(self, generator=None, device=None, tp=None, cuts=None, dtype=None):
        from ...accelerator import resolve_device

        device = resolve_device(device if device is not None or generator is None
                                else generator.device)
        if generator is None:
            generator = torch.Generator(device=device)
            generator.manual_seed(0)
        tied: Dict[str, Any] = {}
        inits: List[Any] = []
        for spec, layer in zip(self.layer_specs, self._built()):
            if isinstance(spec, TiedLayerSpec):
                if spec.key not in tied:
                    tied[spec.key] = _layer_init(layer, generator, device)
                inits.append(_TiedRef(spec.key))
            else:
                inits.append(_layer_init(layer, generator, device))
        if self.num_stages > 1:
            self._uniform_stage_shape(inits)
            lp = len(inits) // self.num_stages
            params = {"stages": [
                {k: torch.stack([inits[s * lp + j][k] for s in range(self.num_stages)])
                 for k in inits[j]} for j in range(lp)]}
            return self.cut_params(params, cuts or {})
        return {"layers": inits, "tied": tied}

    @property
    def param_specs(self):
        """The stage dim of every stacked leaf on 'pipe' (None at one stage:
        replicated)."""
        if self.num_stages <= 1:
            return None
        shapes = self.init_fn(torch.Generator(), device="meta")
        return {"stages": [{k: ("pipe",) + (None,) * (v.dim() - 1) for k, v in t.items()}
                           for t in shapes["stages"]]}

    def shard_params(self, params, index: int, n: int):
        """No leaf is cut over the model axis."""
        return params

    def cut_params(self, params, cuts):
        """This rank's stages of a whole tree (``cuts['pipe'] = (i, n)``)."""
        i, n = cuts.get("pipe", (0, 1))
        if n == 1 or self.num_stages <= 1:
            return params
        return {"stages": [{k: v.chunk(n, 0)[i].clone() for k, v in t.items()}
                           for t in params["stages"]]}

    def _layer_params(self, params, stage: int, first: int = 0) -> List[Any]:
        return [{k: v[stage - first] for k, v in t.items()} for t in params["stages"]]

    def loss_fn(self, params, batch, rng=None):
        """The un-pipelined loss: every layer in order, ``loss_head(out,
        batch)`` plus the layers' aux."""
        if self.loss_head is None:
            raise ValueError("PipelineModule needs loss_fn=(outputs, batch) "
                             "-> scalar to train")
        layers = self._built()
        x = batch["inputs"] if isinstance(batch, dict) else batch
        aux_total = None
        if self.num_stages > 1:
            lp = len(layers) // self.num_stages
            out = x
            for s in range(self.num_stages):
                out, aux = _Stage(layers[s * lp:(s + 1) * lp])(
                    self._layer_params(params, s), out)
                if aux is not None:
                    aux_total = aux if aux_total is None else aux_total + aux
        else:
            tied = params.get("tied", {})
            out = x
            for spec, layer, p in zip(self.layer_specs, layers, params["layers"]):
                if isinstance(p, _TiedRef):
                    p = tied[p.key]
                    fwd = getattr(spec, "forward_fn", None)
                    if fwd is not None:
                        out = fwd(p, out)
                        continue
                out, a = _apply(layer, p, out)
                if a is not None:
                    aux_total = a if aux_total is None else aux_total + a
        loss = self.loss_head(out, batch)
        return loss if aux_total is None else loss + aux_total

    def pipeline_backward(self, params, batch, rng=None, loss_scale: float = 1.0,
                          transport=None, stages=None, reduce_count=None,
                          aux_ranks: int = 1, row0: int = 0):
        """Forward and backward through the stages (``runtime/pipe/
        executor.py``, GPipe): the objective is the mean over the microbatches of
        ``loss_head(out_m, batch_m)`` plus the layers' aux averaged alike,
        over ``aux_ranks`` data ranks; gradients (x ``loss_scale``)
        accumulate into ``params``'s leaves."""
        from .executor import VirtualTransport, run_pipeline

        if self.loss_head is None:
            raise ValueError("PipelineModule needs loss_fn=(outputs, batch) "
                             "-> scalar to train")
        P = self.num_stages
        M = self._microbatches or P
        x_all = batch["inputs"] if isinstance(batch, dict) else batch
        B = x_all.shape[0]
        if B % M:
            raise ValueError(f"batch {B} not divisible by {M} pipeline microbatches")
        mb = B // M
        stages = list(range(P)) if stages is None else list(stages)
        first = stages[0]
        modules = {s: self.stage_module(s) for s in stages}
        aux_sum: List[torch.Tensor] = []

        def micro(m):
            rows = slice(m * mb, (m + 1) * mb)
            if isinstance(batch, dict):
                return {k: v[rows] for k, v in batch.items()}
            return batch[rows]

        def forward(s, m, x):
            if s == 0:
                x = x_all[m * mb:(m + 1) * mb]
            x, aux = modules[s](self._layer_params(params, s, first), x)
            extra = None
            if aux is not None:
                extra = aux / (M * aux_ranks)
                aux_sum.append(extra.detach())
            if s < P - 1:
                return x, extra
            return self.loss_head(x, micro(m)) / (M * aux_ranks), extra

        losses = run_pipeline(forward, P, M, stages, transport or VirtualTransport(),
                              (mb,) + tuple(x_all.shape[1:]), x_all.dtype,
                              loss_scale=loss_scale)
        return losses, (torch.stack(aux_sum).sum() if aux_sum else None)
