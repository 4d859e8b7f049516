"""The port's flops profiler (``deepspeed_tpu_torch/profiling``) against
the JAX package's and against the analytic count of the work executed.

The port counts what runs (``torch.utils.flop_counter``: ``2*M*K*N`` a
matmul, nothing for elementwise operations) plus each flash-kernel launch's
own count; XLA's cost analysis counts elementwise operations too.  So:

- the port's counts are exact against ``2*M*K*N`` summed over the model's
  matmuls (every projection, the MLP, the head, and the plain attention
  branch's two ``[S, S]`` products a head), for the forward
  (``get_model_profile``, ``get_detailed_profile``'s rows) and for an
  engine's step at ``profile_step`` (forward, backward's two products a
  matmul, and a remat recompute of the layers but their last product);
- against JAX's ``get_detailed_profile`` on ``tiny``: the port's dense and
  attention per-token coefficients are at most JAX's and at least 0.90x
  (dense) and 0.75x (attention) of them — XLA adds the norms', residuals'
  and softmax's elementwise work (measured 0.93x and 0.81x at S=64/128);
- the number-to-string helpers: equal to JAX's.
"""
import json

import numpy as np
import pytest
import torch

from deepspeed_tpu.models import CausalLM as JaxCausalLM
from deepspeed_tpu.profiling import flops_profiler as JP

import deepspeed_tpu_torch as ds
from deepspeed_tpu_torch.models import CausalLM
from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
from deepspeed_tpu_torch.ops.kernels.common import note_cost
from deepspeed_tpu_torch.profiling import flops_profiler as TP
from deepspeed_tpu_torch.profiling.flops_profiler.profiler import CostCounter

torch.set_num_threads(1)
NAMES = ["tiny", "tiny-gqa", "tiny-gpt2"]


def _analytic(model, B: int, S: int) -> dict:
    """2*M*K*N of each matmul of a forward over [B, S] tokens: the layer
    matrices (every stacked ``[L, in, out]`` leaf of ``layers``), the head
    (the embedding's transpose when tied), and the plain
    attention's QK^T and PV over every (query, key) pair."""
    cfg = model.config
    shapes = model.init_fn(torch.Generator(), device="meta")
    T = B * S
    layer_mm = sum(2 * T * x.shape[0] * x.shape[1] * x.shape[2]
                   for x in shapes["layers"].values() if x.dim() == 3)
    head = 2 * T * cfg.hidden_size * cfg.vocab_size
    attn = 2 * 2 * B * cfg.num_heads * S * S * cfg.dims_per_head * cfg.num_layers
    return {"layers": layer_mm, "head": head, "attn": attn,
            "total": layer_mm + head + attn}


@pytest.mark.parametrize("name", NAMES)
def test_model_profile_counts_every_matmul(name, tmp_path):
    model = CausalLM(name, dtype=torch.float32)
    flops, macs, params = TP.get_model_profile(model, 2, 64, as_string=False,
                                               print_profile=True, device="cpu",
                                               output_file=str(tmp_path / "p.txt"))
    want = _analytic(model, 2, 64)
    assert flops == want["total"] and macs == flops / 2
    assert params == model.config.param_count
    report = (tmp_path / "p.txt").read_text()
    assert "fwd flops (counted)" in report and "layer.attention_core" in report
    strings = TP.get_model_profile(model, 2, 64, print_profile=False, device="cpu")
    assert strings[0] == TP.flops_to_string(flops)


@pytest.mark.parametrize("name", NAMES)
def test_detailed_profile_rows_are_exact(name):
    model = CausalLM(name, dtype=torch.float32, attn_impl="auto")
    B, S = 2, 128
    det = TP.get_detailed_profile(model, B, S, device="cpu")
    rows = {r["name"]: r for r in det["modules"]}
    want = _analytic(model, B, S)
    cfg = model.config
    L = cfg.num_layers
    assert rows["layer.attention_core"]["flops"] == want["attn"]
    assert rows["layer.attention_core"]["count"] == L
    assert rows["lm_head"]["flops"] == want["head"]
    assert rows["layer.mlp"]["flops"] + rows["layer.qkv_out_projections+norms"]["flops"] \
        == want["layers"]
    assert rows["embed"]["flops"] == 0 and rows["other (final norm, residuals, loss)"][
        "flops"] == 0
    assert det["total"]["flops"] == want["total"]
    assert det["attn_flops_per_token"] == want["attn"] / (B * S)
    assert det["dense_flops_per_token"] == (want["total"] - want["attn"]) / (B * S)
    assert sum(r["pct"] for r in det["modules"]) == pytest.approx(100.0, abs=0.5)
    assert all(r["bytes"] >= 0 for r in det["modules"])
    assert model.attn_impl == "auto"      # pinned on a copy, the caller's untouched


@pytest.mark.parametrize("S", [64, 128])
def test_profile_coefficients_within_band_of_jax(S):
    jd = JP.get_detailed_profile(JaxCausalLM("tiny"), 2, S)
    td = TP.get_detailed_profile(CausalLM("tiny", dtype=torch.float32), 2, S, device="cpu")
    dense = td["dense_flops_per_token"] / jd["dense_flops_per_token"]
    attn = td["attn_flops_per_token"] / jd["attn_flops_per_token"]
    assert 0.90 <= dense <= 1.0, dense
    assert 0.75 <= attn <= 1.0, attn
    jf = JP.get_model_profile(JaxCausalLM("tiny"), 2, S, as_string=False, print_profile=False)
    tf = TP.get_model_profile(CausalLM("tiny", dtype=torch.float32), 2, S, as_string=False,
                              print_profile=False, device="cpu")
    assert 0.85 <= tf[0] / jf[0] <= 1.0 and tf[2] == jf[2]


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_engine_profile_step_counts_the_step(remat, tmp_path):
    """The step at ``profile_step`` (and only it) runs under the counter:
    forward, the backward's two products a matmul, and under
    ``nothing_saveable`` the layers' recomputed forward but its last
    product."""
    out = tmp_path / "profile.txt"
    model = CausalLM("tiny", dtype=torch.float32, remat=remat)
    eng, *_ = ds.initialize(model=model, device="cpu", config={
        "train_batch_size": 2, "flops_profiler": {
            "enabled": True, "profile_step": 2, "output_file": str(out)}})
    batch = {"input_ids": np.random.default_rng(0).integers(0, 256, (2, 64))}
    eng.train_batch(batch=batch)
    assert not out.exists() and eng.flops_profiler.get_total_flops() == 0
    eng.train_batch(batch=batch)
    want = _analytic(model, 2, 64)
    fwd, cfg = want["total"], model.config
    # the recompute stops at the last tensor the backward reads (torch's
    # checkpoint stops early): the block's last product, w_down's, whose
    # output no backward needs, is not run again
    last = 2 * 2 * 64 * cfg.num_layers * cfg.intermediate_size * cfg.hidden_size
    recompute = (want["layers"] - last + want["attn"]) if remat else 0
    assert eng.flops_profiler.get_total_flops() == 3 * fwd + recompute
    d = json.loads(eng.flops_profiler.to_json())
    assert d["flops"] == 3 * fwd + recompute and d["params"] == eng.param_count
    assert d["duration_s"] > 0 and d["bytes accessed"] > 0 and d["kernel_flops"] == 0
    report = out.read_text()
    assert "train step @ step 2" in report and "analytic model flops" in report
    out.unlink()
    eng.train_batch(batch=batch)
    assert not out.exists()


def test_kernel_launches_are_counted_per_launch():
    """A flash kernel launches through ctypes, where the dispatcher cannot
    see it: each launch adds ``kernel_cost``, held here against the
    products and bytes counted by hand."""
    q = torch.zeros(2, 256, 4, 64, dtype=torch.bfloat16)
    k = torch.zeros(2, 256, 2, 64, dtype=torch.bfloat16)
    with CostCounter() as counter:
        fa._note_launch("flash_attention", "fwd", q, k, True, None)
        fa._note_launch("flash_attention_bwd_dq", "dq", q, k, True, None)
        fa._note_launch("flash_attention_bwd_dkv", "dkv", q, k, False, None)
        note_cost("other", 10.0, 4.0)
    pairs_c, pairs_f = 256 * 257 // 2, 256 * 256
    want = 2 * 2 * 4 * 64 * (2 * pairs_c + 3 * pairs_c + 4 * pairs_f) + 10.0
    cost = counter.cost()
    assert cost["kernel_flops"] == cost["flops"] == want
    assert cost["kernel_launches"] == {"flash_attention": 1, "flash_attention_bwd_dq": 1,
                                       "flash_attention_bwd_dkv": 1, "other": 1}
    e, Bq, Bkv, Br = 2, 2 * 256 * 4 * 64 * 2, 2 * 256 * 2 * 64 * 2, 4 * 2 * 4 * 256
    assert cost["kernel_bytes"] == (2 * Bq + 2 * Bkv + Br) + (3 * Bq + 2 * Bkv + 2 * Br) \
        + (2 * Bq + 4 * Bkv + 2 * Br) + 4.0 and e == q.element_size()
    mask = np.ones((2, 2), bool)
    mask[0, 1] = False
    assert fa.attended_pairs(256, False, mask) == 256 * 256 - 128 * 128
    with CostCounter() as counter:   # nothing listens outside the context
        pass
    fa._note_launch("flash_attention", "fwd", q, k, True, None)
    assert counter.cost()["kernel_flops"] == 0


def test_cost_analysis_of_counts_bytes_of_non_view_ops():
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    ca = TP.cost_analysis_of(lambda x, y: (x @ y).t().contiguous(), a, b)
    assert ca["flops"] == 2 * 8 * 16 * 4
    # mm reads 512 + 256 B and writes 128 B; the transpose is a view; the
    # copy reads and writes 128 B
    assert ca["bytes accessed"] == (8 * 16 + 16 * 4 + 8 * 4) * 4 + 2 * 8 * 4 * 4
    assert ca["output"].shape == (4, 8)


def test_number_strings_match_jax():
    for x in (0.0, 12.5, 3.2e3, 4.56e6, 7.891e9, 1.2345e12, 9.9e15):
        assert TP.flops_to_string(x) == JP.flops_to_string(x)
        assert TP.macs_to_string(x) == JP.macs_to_string(x)
        assert TP.params_to_string(x) == JP.params_to_string(x)
        assert TP.number_to_string(x, "B", 3) == JP.number_to_string(x, "B", 3)


def test_offload_param_refuses_the_profiler(tmp_path):
    with pytest.raises(NotImplementedError,
                       match="offload_param \\+ flops_profiler: the profiler hooks"):
        ds.initialize(model=CausalLM("tiny", dtype=torch.bfloat16), device="cpu", config={
            "train_batch_size": 2, "bf16": {"enabled": True},
            "flops_profiler": {"enabled": True},
            "zero_optimization": {"stage": 3, "offload_param": {
                "device": "nvme", "nvme_path": str(tmp_path)}}})
