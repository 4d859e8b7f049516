"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--profile]

Run from the root of a checkout on a machine with a CUDA card.  Phases,
one JSON line each; any failure exits non-zero with no result line:

1. environment and build: the card (``nvidia-smi`` name and power limit),
   torch/CUDA versions, and the nvcc build of every kernel from the sources
   in the checkout;
2. each kernel against its plain PyTorch version on the card, at the main
   path's shapes and a few more, with kernel / plain / library timings
   (CUDA events, median of 20 after warm-up);
3. the serving path at full llama2-7b width and depth with random weights
   from the seed: ``init_inference`` -> ``engine.forward`` on S=4096 (the
   flash kernel must launch once per layer), the same tokens through the
   plain attention branch and through an fp32 engine (top-1 agreement),
   then greedy ``generate`` on 4 ragged prompts, twice (must be
   token-equal);
4. with ``--profile`` only: ``torch.profiler`` device time by kernel for
   one warm forward and one decode step, and the device's busy share;
5. the ``kernels`` line: per kernel its launches on the main path, error
   against the plain version, times and the bound from this run's shapes.

The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): tensor-core bf16/fp16,
# CUDA-core fp32, HBM3 bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12

# (B, S, Hq, Hkv, hd, dtype, causal); the first is the main path's launch
# at llama2-7b shapes (one per layer of engine.forward at S=4096)
KERNEL_SHAPES = [
    (1, 4096, 32, 32, 128, torch.bfloat16, True),
    (2, 2048, 32, 8, 128, torch.bfloat16, True),
    (2, 2048, 12, 12, 64, torch.bfloat16, True),
    (1, 2048, 16, 16, 128, torch.bfloat16, False),
    (1, 1024, 8, 8, 128, torch.float16, True),
    (1, 1024, 8, 2, 64, torch.float32, True),
]
# out tolerance per dtype: bf16/fp16 P is rounded before P.V and sums run in
# another order; fp32 differs in summation order only.  lse is fp32 always.
OUT_TOL = {torch.bfloat16: 2e-2, torch.float16: 1e-2, torch.float32: 1e-4}
LSE_ATOL = 1e-3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, by CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def attention_bound_ms(B, S, Hq, Hkv, hd, dtype, causal) -> tuple:
    """Least time for the work these inputs need: two products over the
    attended (query, key) pairs at the dtype's peak, against q/k/v read once
    and out/lse written once at the memory rate."""
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 4.0 * B * Hq * pairs * hd
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = esize * (2 * B * S * Hq * hd + 2 * B * S * Hkv * hd) + 4 * B * Hq * S
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def phase_build():
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.op_builder import BUILD_DIR

    b = fa.builder()
    t0 = time.perf_counter()
    b.load()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_kernel_seconds": {b.name: b.build_seconds},
          "build_dir": str(BUILD_DIR),
          "ptxas_sample": {b.name: [ln.strip() for ln in b.log.splitlines()
                                    if "registers" in ln or "spill" in ln][:4]}})


def phase_kernels(gen: torch.Generator):
    """Flash forward vs its plain version; returns the main shape's record."""
    from deepspeed_tpu_torch.ops.kernels.flash_attention import (
        flash_attention, flash_attention_reference)

    records = []
    for (B, S, Hq, Hkv, hd, dtype, causal) in KERNEL_SHAPES:
        q, k, v = (torch.randn((B, S, H, hd), generator=gen, device="cuda",
                               dtype=torch.float32).to(dtype)
                   for H in (Hq, Hkv, Hkv))
        with torch.inference_mode():
            out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
            torch.cuda.synchronize()
            ref, ref_lse = flash_attention_reference(q, k, v, causal, None, True)
            err = (out.float() - ref.float()).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            tol = OUT_TOL[dtype]
            close = torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol)
            kernel_ms = time_ms(lambda: flash_attention(q, k, v, causal=causal))
            plain_ms = time_ms(lambda: flash_attention_reference(q, k, v, causal))
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=Hq != Hkv))
        bound, bound_by = attention_bound_ms(B, S, Hq, Hkv, hd, dtype, causal)
        rec = {"phase": "kernel", "name": "flash_attention_fwd",
               "shape": {"B": B, "S": S, "Hq": Hq, "Hkv": Hkv, "hd": hd,
                         "dtype": str(dtype).replace("torch.", ""),
                         "causal": causal},
               "max_abs_err": err, "lse_max_abs_err": lse_err,
               "out_tol": tol, "lse_atol": LSE_ATOL, "ms": kernel_ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound, "bound_by": bound_by,
               "bound_share": bound / kernel_ms}
        emit(rec)
        check(close and lse_err <= LSE_ATOL,
              f"flash_attention_fwd disagrees with its plain version at "
              f"{rec['shape']}: out err {err} (tol {tol}), lse err {lse_err}")
        records.append(rec)
        del q, k, v, out, lse, ref, ref_lse
        torch.cuda.empty_cache()
    return records[0]


def fp32_reference_logits(params, tokens) -> torch.Tensor:
    """The same weights and tokens through an fp32 engine on the plain
    attention branch: the reference both bf16 paths are held to."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import CausalLM

    ref_model = CausalLM("llama2-7b", attn_impl="xla", dtype=torch.float32)
    engine = deepspeed_tpu_torch.init_inference(
        ref_model, config={"dtype": "fp32"}, params=params)
    logits = engine.forward(tokens).float()
    del engine
    torch.cuda.empty_cache()
    return logits


def device_activity(events):
    """Busy time (us) as the union of the device intervals, and per-name
    (total us, count).  The profiler's "Command Buffer Full" markers are
    host stalls, not device work, and are left out."""
    from torch.autograd import DeviceType

    spans, by_name = [], {}
    for e in events:
        if e.device_type != DeviceType.CUDA or "Command Buffer" in e.name:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        total, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (total + e.time_range.elapsed_us(), n + 1)
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(spans):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy, by_name


def phase_profile(engine, tokens):
    """Where the time goes (``--profile``): one warm ``engine.forward`` and
    one ``generate`` of 2 new tokens for 4 prompts of 128 (a prefill plus
    one decode step) under ``torch.profiler``: device time by kernel (top
    12), the flash kernel's share, and the device's busy share of the wall
    time."""
    from torch.profiler import ProfilerActivity, profile

    ids = tokens[:, :128].repeat(4, 1)
    for label, fn in (("forward", lambda: engine.forward(tokens)),
                      ("generate_2_tokens", lambda: engine.generate(
                          ids, max_new_tokens=2))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy_us, by_name = device_activity(prof.events())
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
        flash_us = sum(t for name, (t, _) in by_name.items() if "flash_fwd" in name)
        emit({"phase": "profile", "what": label, "wall_ms": wall * 1e3,
              "device_busy_ms": busy_us / 1e3,
              "device_busy_share": busy_us / 1e3 / (wall * 1e3),
              "flash_kernel_ms": flash_us / 1e3,
              "top_kernels": [{"name": name[:90], "ms": t / 1e3, "count": n}
                              for name, (t, n) in top[:12]]})


def phase_serving(seed: int, profile: bool):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import CausalLM
    from deepspeed_tpu_torch.ops.kernels.flash_attention import flash_attention

    model = CausalLM("llama2-7b")          # attn_impl="auto", bf16 activations
    cfg = model.config
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    params = model.init_fn(gen, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    engine = deepspeed_tpu_torch.init_inference(model, config={"dtype": "bf16"},
                                                params=params)
    n_params = sum(x.numel() for x in params["layers"].values()) + \
        params["embed"].numel() + params["lm_head"].numel() + \
        params["final_norm_scale"].numel()
    emit({"phase": "init", "model": "llama2-7b", "params": n_params,
          "layers": cfg.num_layers, "seconds": time.perf_counter() - t0,
          "weights_gb": torch.cuda.memory_allocated() / 1e9})

    S = 4096
    tokens = torch.randint(0, cfg.vocab_size, (1, S), generator=gen,
                           device="cuda")
    # the main path: counts to 0 just before, read just after
    flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = engine.forward(tokens)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = flash_attention.launches
    check(launches == cfg.num_layers,
          f"engine.forward launched flash_attention_fwd {launches} times, "
          f"expected one per layer ({cfg.num_layers})")
    check(tuple(logits.shape) == (1, S, cfg.vocab_size),
          f"logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    t0 = time.perf_counter()
    engine.forward(tokens)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    model.attn_impl = "xla"                # the plain attention branch
    before = flash_attention.launches
    plain = engine.forward(tokens)
    torch.cuda.synchronize()
    model.attn_impl = "auto"
    check(flash_attention.launches == before, "plain branch launched the kernel")
    ref = fp32_reference_logits(params, tokens)
    ref_top2 = ref.topk(2, dim=-1).values
    margin = ref_top2[..., 0] - ref_top2[..., 1]
    # bf16 noise level: how far the plain branch itself strays from fp32
    plain_dev = (plain.float() - ref).abs()
    flash_dev = (logits.float() - ref).abs()
    noise = plain_dev.max().item()
    decisive = margin > noise
    top1 = {name: x.argmax(-1) for name, x in
            (("flash", logits), ("plain", plain), ("ref", ref))}

    def agree(a, b, where=None):
        same = (top1[a] == top1[b]).float()
        return (same[where] if where is not None else same).mean().item()

    rec = {"phase": "forward", "S": S, "flash_launches": launches,
           "cold_s": cold_s, "warm_s": warm_s, "prefill_tok_per_s": S / warm_s,
           "max_abs_dlogits_vs_plain": (logits.float() - plain.float()).abs().max().item(),
           "max_abs_dlogits_vs_fp32": flash_dev.max().item(),
           "mean_abs_dlogits_vs_fp32": flash_dev.mean().item(),
           "plain_max_abs_dlogits_vs_fp32": noise,
           "plain_mean_abs_dlogits_vs_fp32": plain_dev.mean().item(),
           "top1_agreement_vs_plain": agree("flash", "plain"),
           "top1_agreement_vs_fp32": agree("flash", "ref"),
           "plain_top1_agreement_vs_fp32": agree("plain", "ref"),
           "decisive_positions": int(decisive.sum()),
           "top1_agreement_vs_plain_decisive": agree("flash", "plain", decisive),
           "top1_agreement_vs_fp32_decisive": agree("flash", "ref", decisive),
           "logits_abs_max": logits.float().abs().max().item()}
    emit(rec)
    # Random weights leave top-1 margins inside bf16 noise at most positions,
    # so any two bf16 attention paths disagree there (PERF.md).  The
    # gates: over every position, the kernel path's logits are no further
    # from the fp32 run (max and mean |dlogits|) than the plain branch's;
    # on positions whose fp32 margin exceeds the plain branch's own
    # deviation from fp32, the kernel path agrees >= 99%; and its overall
    # top-1 agreement with fp32 is the plain branch's or better (2-point
    # slack).
    check(rec["max_abs_dlogits_vs_fp32"] <= rec["plain_max_abs_dlogits_vs_fp32"]
          and rec["mean_abs_dlogits_vs_fp32"]
          <= rec["plain_mean_abs_dlogits_vs_fp32"],
          f"kernel path's logits stray further from fp32 than the plain "
          f"branch's: {rec}")
    check(rec["decisive_positions"] >= 32, "too few decisive positions to judge")
    check(rec["top1_agreement_vs_plain_decisive"] >= 0.99
          and rec["top1_agreement_vs_fp32_decisive"] >= 0.99,
          f"top-1 agreement on decisive positions below 0.99: {rec}")
    check(rec["top1_agreement_vs_fp32"] >= rec["plain_top1_agreement_vs_fp32"] - 0.02,
          f"kernel path strays further from fp32 than the plain branch: {rec}")
    del logits, plain, ref, plain_dev, flash_dev

    lengths = [17, 45, 90, 128]
    ids = torch.zeros((4, max(lengths)), dtype=torch.long)
    mask = torch.zeros((4, max(lengths)), dtype=torch.bool)
    cpu_gen = torch.Generator().manual_seed(seed + 1)
    for i, n in enumerate(lengths):
        ids[i, :n] = torch.randint(0, cfg.vocab_size, (n,), generator=cpu_gen)
        mask[i, :n] = True
    new = 32
    first = engine.generate(ids, max_new_tokens=new, attention_mask=mask)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    second = engine.generate(ids, max_new_tokens=new, attention_mask=mask)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    check(tuple(second.shape) == (4, max(lengths) + new),
          f"generate shape {tuple(second.shape)}")
    check(torch.equal(first, second), "greedy generate is not deterministic")
    gen_tokens = second[:, max(lengths):]
    check(bool(((gen_tokens >= 0) & (gen_tokens < cfg.vocab_size)).all()),
          "generated token ids out of range")
    # cross-check: the longest (unpadded) row's first token is the argmax of
    # the full-sequence forward's last logits (reported, not asserted: the
    # two paths round bf16 attention differently)
    fwd = engine.forward(ids[3:4, :128])
    same_first = int(fwd[0, -1].argmax()) == int(second[3, 128])
    emit({"phase": "generate", "prompts": lengths, "new_tokens": new,
          "seconds": gen_s, "tok_per_s": 4 * new / gen_s,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "deterministic": True,
          "first_token_matches_forward_argmax": same_first})
    if profile:
        phase_profile(engine, tokens)
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also profile one forward and one decode step")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 references in fp32
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    t_start = time.perf_counter()
    phase_build()
    main_rec = phase_kernels(torch.Generator(device="cuda").manual_seed(args.seed))
    launches = phase_serving(args.seed, args.profile)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "deepspeed_tpu_torch/ops/csrc/flash_attention_fwd.cu",
        "replaces": "deepspeed_tpu/ops/pallas/flash_attention.py:74",
        "launches": launches, "max_abs_err": main_rec["max_abs_err"],
        "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"], "bound_by": main_rec["bound_by"],
        "library_ms": main_rec["library_ms"]}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
