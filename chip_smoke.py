"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--profile]

Run from the root of a checkout on a machine with a CUDA card.  Phases,
one JSON line each; any failure exits non-zero with no result line:

1. environment and build: the card (``nvidia-smi`` name and power limit),
   torch/CUDA versions, and the nvcc builds of every kernel source in the
   checkout, in parallel, with ptxas registers and spills per kernel;
2. each kernel against its plain PyTorch version on the card, at the main
   paths' shapes and a few more, with kernel / plain / library timings
   (CUDA events, median of 20 after warm-up): K1 the flash forward, K2 the
   dq backward and K3 the dk/dv backward; then the yardstick of the decode
   kernel still to be ported (K4): its bound and the library's time;
3. the training path (this slice's main path): ``initialize`` ->
   ``train_batch`` on llama-740m at full width and depth, S=16384, micro
   batch 1, bf16 over fp32 masters, AdamW (bf16 mu), full-layer remat;
   2 warm and 5 timed steps on one batch from the seed.  Every step must
   launch K1 2L times (forward and remat recompute), K2 and K3 L times,
   and the loss must stay finite and fall;
4. training parity at S=2048: 3 steps from the same weights and batch
   through the kernels and through the plain attention branch (which must
   launch none); losses and the gradient norm must agree, and both are
   held beside an fp32 engine;
5. the serving path at full llama2-7b width and depth with random weights
   from the seed: ``init_inference`` -> ``engine.forward`` on S=4096 (K1
   must launch once per layer), the same tokens through the plain
   attention branch and through an fp32 engine (logit gates), then greedy
   ``generate`` on 4 ragged prompts, twice (must be token-equal);
6. with ``--profile`` only: ``torch.profiler`` device time by kernel for
   one warm train step, one forward and one decode step, and the device's
   busy share;
7. the ``kernels`` line: per kernel its launches on the training path,
   error against the plain version, times and the bound from this run's
   shapes.

The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): tensor-core bf16/fp16,
# CUDA-core fp32, HBM3 bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12

# (B, S, Hq, Hkv, hd, dtype, causal).  K1's first shape is the training
# path's (2 launches per layer per step), its second the serving path's
# (one per layer of engine.forward at llama2-7b, S=4096).
TRAIN_SHAPE = (1, 16384, 14, 14, 128, torch.bfloat16, True)
SERVE_SHAPE = (1, 4096, 32, 32, 128, torch.bfloat16, True)
FWD_SHAPES = [
    TRAIN_SHAPE,
    SERVE_SHAPE,
    (2, 2048, 32, 8, 128, torch.bfloat16, True),
    (2, 2048, 12, 12, 64, torch.bfloat16, True),
    (1, 2048, 16, 16, 128, torch.bfloat16, False),
    (1, 1024, 8, 8, 128, torch.float16, True),
    (1, 1024, 8, 2, 64, torch.float32, True),
]
# K2/K3 (bf16/fp16 only: fp32 gradients on CUDA raise, checked below)
BWD_SHAPES = [
    TRAIN_SHAPE,
    (2, 2048, 32, 8, 128, torch.bfloat16, True),
    (2, 2048, 12, 12, 64, torch.bfloat16, True),
    (1, 2048, 16, 16, 128, torch.bfloat16, False),
    (1, 1024, 8, 8, 128, torch.float16, True),
]
# From this length on, one fp32 [S, S] score plane per head is over 0.27 GB
# and the plain versions run on slices of PLAIN_HEADS heads: compared on the
# first slice, timed over all of them.
CHUNK_FROM_S = 8192
PLAIN_HEADS = 2
# Agreement with the plain version, per output tensor [B, S, H, hd]:
#  - the relative error ||got - ref|| / ||ref|| of every 128-row tile of
#    every (batch, head), the worst tile gated.  Tile by tile, rows with
#    small values (the long rows and late keys of a causal plane, where
#    |dq| ~ sqrt(e/n)) are held as tightly as the large early ones;
#  - per element, |got - ref| <= elem_rtol |ref| + elem_atol_rms * rms(ref),
#    for a single wrong element inside a tile.
# bf16/fp16 P and dS are rounded to the input dtype before their products
# and sums run in another order; fp32 differs in summation order only.  K1
# rounds the unnormalised P of its online softmax, the plain version the
# normalised one, so its errors are larger than K2/K3's.  Each limit lies
# between two readings on the H100 (PERF.md): above the worst tile error
# and per-element need of the kernel over every shape here and in
# tests/test_torch_kernels_gpu.py, and below the worst-tile error of the
# lower-precision yardstick (``plain_low_precision``); both yardsticks must
# be rejected in every run.
AGREE_TOL = {
    # K1: worst tile 3.3e-3 bf16 / 4.0e-4 fp16 / 7.9e-7 fp32; yardstick
    # >= 5.9e-3 / 8.6e-4 / 4.7e-3.  Per element: needs <= 0.063 / 0.003.
    "fwd": {
        torch.bfloat16: {"tile_rel": 4.5e-3, "elem_rtol": 2e-2, "elem_atol_rms": 0.1},
        torch.float16: {"tile_rel": 6e-4, "elem_rtol": 2e-2, "elem_atol_rms": 1e-2},
        torch.float32: {"tile_rel": 1e-5, "elem_rtol": 1e-4, "elem_atol_rms": 1e-3},
    },
    # K2/K3: worst tile 8.7e-4 bf16 / 8.7e-5 fp16; yardstick >= 6.7e-3 /
    # 1.0e-3.  Per element: needs <= 0.008 / 0.0011, yardstick >= 0.064 / 0.010.
    "bwd": {
        torch.bfloat16: {"tile_rel": 3e-3, "elem_rtol": 2e-2, "elem_atol_rms": 3e-2},
        torch.float16: {"tile_rel": 4e-4, "elem_rtol": 2e-2, "elem_atol_rms": 5e-3},
    },
}
LSE_ATOL = 1e-5   # lse is fp32 always: 1.9e-6 at most on the H100

# bench.py's training defaults, on the port
TRAIN_MODEL = "llama-740m"
TRAIN_CONFIG = {
    "train_micro_batch_size_per_gpu": 1,
    "gradient_accumulation_steps": 1,
    "optimizer": {"type": "adamw",
                  "params": {"lr": 1e-4, "mu_dtype": "bfloat16",
                             "nu_dtype": "float32"}},
    "zero_optimization": {"stage": 1},
    "bf16": {"enabled": True},
    "data_types": {"grad_accum_dtype": "bf16"},
    "steps_per_print": 10 ** 9,
}
WARM_STEPS, TIMED_STEPS = 2, 5
PARITY_S, PARITY_STEPS = 2048, 3
# bf16 kernel path vs bf16 plain branch (P rounded at different points),
# every step: a few times the gaps measured on the card (5.7e-4 in loss,
# 0.67% in gradient norm at step 3; PERF.md)
PARITY_LOSS_RTOL = 2e-3
PARITY_GRAD_NORM_RTOL = 2e-2
GEN_PROMPTS, GEN_NEW = [17, 45, 90, 128], 32


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def free_memory() -> None:
    gc.collect()
    torch.cuda.empty_cache()


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


def _bound(flops: float, nbytes: float, dtype) -> tuple:
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _pairs(S: int, causal: bool) -> int:
    return S * (S + 1) // 2 if causal else S * S


def attention_bound_ms(B, S, Hq, Hkv, hd, dtype, causal, kernel="fwd") -> tuple:
    """Least time for the work these inputs need, at the dtype's peak or
    the memory rate.  Products over the attended (query, key) pairs: the
    forward does 2 (QK^T, PV), K2 3 (QK^T, dO V^T, dS K), K3 4 (the same
    two scores, P^T dO, dS^T Q).  Bytes: each input read once, each output
    written once (fp32 lse/delta rows [B, Hq, S])."""
    esize = torch.tensor([], dtype=dtype).element_size()
    q_bytes, kv_bytes, row_bytes = (esize * B * S * Hq * hd, esize * B * S * Hkv * hd,
                                    4 * B * Hq * S)
    gemms, nbytes = {
        "fwd": (2, 2 * q_bytes + 2 * kv_bytes + row_bytes),             # q,k,v -> out,lse
        "dq": (3, 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes),         # q,k,v,dO,lse,delta -> dq
        "dkv": (4, 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes),        # ... -> dk,dv
    }[kernel]
    flops = gemms * 2.0 * B * Hq * _pairs(S, causal) * hd
    return _bound(flops, nbytes, dtype)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def _kernel_label(mangled: str) -> str:
    name = re.search(r"\d+(flash_\w+?_kernel)", mangled)
    hd = re.search(r"Li(\d+)E", mangled)
    dtype = ("bf16" if "bfloat16" in mangled else "fp16" if "half" in mangled
             else "fp32")
    return (f"{name.group(1) if name else mangled[:60]}<{dtype},"
            f"hd{hd.group(1) if hd else '?'},causal={int('Lb1E' in mangled)}>")


def ptxas_report(log: str) -> dict:
    """{kernel: {registers, spill_stores, spill_loads}} from nvcc -Xptxas=-v."""
    out, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = _kernel_label(m.group(1))
            out[current] = {}
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[current]["spill_stores"] = int(m.group(1))
            out[current]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[current]["registers"] = int(m.group(1))
    return out


def phase_build():
    """Every kernel source, one nvcc each, all started together."""
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.op_builder import BUILD_DIR

    builders = fa.builders()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builders)) as pool:
        list(pool.map(lambda b: b.load(), builders))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_seconds": {b.name: b.build_seconds for b in builders},
          "build_dir": str(BUILD_DIR),
          "ptxas": {b.name: ptxas_report(b.log) for b in builders}})


def _heads(x, lo, hi, dim=2):
    return x.narrow(dim, lo, hi - lo).contiguous()


def _slices(shape):
    """Head ranges the plain versions run on: None (all heads at once), or
    slices of PLAIN_HEADS heads (MHA only) from CHUNK_FROM_S on."""
    B, S, Hq, Hkv, hd, dtype, causal = shape
    if S < CHUNK_FROM_S:
        return None
    check(Hq == Hkv and Hq % PLAIN_HEADS == 0, "head slices need MHA")
    return [(h, h + PLAIN_HEADS) for h in range(0, Hq, PLAIN_HEADS)]


def _parts(slices, *tensors):
    """The plain version's inputs per head slice: q-like tensors sliced on
    dim 2, the fp32 [B, H, S] rows (lse, delta) on dim 1."""
    if slices is None:
        return [list(tensors)]
    return [[_heads(x, a, b, 2 if x.dim() == 4 else 1) for x in tensors]
            for a, b in slices]


def _inputs(gen, shape, n):
    B, S, Hq, Hkv, hd, dtype, causal = shape
    heads = (Hq, Hkv, Hkv, Hq)[:n]
    return [torch.randn((B, S, H, hd), generator=gen, device="cuda",
                        dtype=torch.float32).to(dtype) for H in heads]


def _shape_dict(shape, slices):
    B, S, Hq, Hkv, hd, dtype, causal = shape
    d = {"B": B, "S": S, "Hq": Hq, "Hkv": Hkv, "hd": hd,
         "dtype": str(dtype).replace("torch.", ""), "causal": causal}
    if slices is not None:
        d["plain_on"] = (f"heads {slices[0][0]}-{slices[0][1] - 1} compared; "
                         f"plain_ms over all {len(slices)} slices of "
                         f"{PLAIN_HEADS} heads")
    return d


def agreement(got, ref, tol: dict, tile: int = 128) -> dict:
    """How far ``got`` [B, S, H, hd] is from the plain version ``ref``, and
    whether that is within ``tol`` (an ``AGREE_TOL`` entry; key ``ok``)."""
    got, ref = got.float(), ref.float()
    diff = got - ref
    B, S, H, hd = ref.shape

    def tile_norms(x):
        return x.reshape(B, S // tile, tile, H, hd).pow(2).sum((2, 4)).sqrt()

    rms = ref.pow(2).mean().sqrt().item()
    tile_rel = (tile_norms(diff) / tile_norms(ref)).max().item()
    # the smallest elem_atol_rms this pair passes at the dtype's elem_rtol
    atol_needed = ((diff.abs() - tol["elem_rtol"] * ref.abs()).clamp(min=0).max()
                   .item() / rms)
    return {"max_abs_err": diff.abs().max().item(),
            "max_abs_ref": ref.abs().max().item(), "rms_ref": rms,
            "rel_l2": (diff.norm() / ref.norm()).item(),
            "worst_tile_rel_l2": tile_rel, "elem_atol_rms_needed": atol_needed,
            "ok": tile_rel <= tol["tile_rel"] and atol_needed <= tol["elem_atol_rms"]}


def plain_low_precision(q, k, v, causal, do=None, lse=None, delta=None):
    """The yardstick the gates must reject: the plain formulas with the
    scores S (and dP) rounded to the input dtype after their products, as
    a kernel that kept them in half precision would (to bf16 for fp32
    inputs).  Returns out, or (dq, dk, dv) when given dO, lse and delta."""
    B, S, Hq, hd = q.shape
    Hkv, scale = k.shape[2], 1.0 / math.sqrt(hd)
    kr, vr = (x.repeat_interleave(Hq // Hkv, dim=2) for x in (k, v))
    low = torch.bfloat16 if q.dtype == torch.float32 else q.dtype
    s = (torch.einsum("bqhd,bkhd->bhqk", q, kr) * scale).to(low)
    if causal:
        keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    if do is None:
        p = torch.softmax(s, dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", p, vr)
    p = torch.exp(s.float() - lse[..., None]).to(q.dtype)
    del s
    dp = torch.einsum("bqhd,bkhd->bhqk", do, vr)
    ds = (p.float() * (dp.float() - delta[..., None]) * scale).to(q.dtype)
    del dp

    def group_sum(x):
        return x.float().reshape(B, S, Hkv, Hq // Hkv, hd).sum(3).to(q.dtype)

    return (torch.einsum("bhqk,bkhd->bqhd", ds, kr),
            group_sum(torch.einsum("bhqk,bqhd->bkhd", ds, q)),
            group_sum(torch.einsum("bhqk,bqhd->bkhd", p, do)))


def compare(got, ref, low, tol: dict, tile: int = 128) -> dict:
    """``agreement`` of the kernel's output, with the readings of two
    yardsticks beside it: the lower-precision version ``low``, and the
    kernel's output with its last ``tile`` rows zeroed (a grid one CTA
    short: the longest causal rows for dq and out, the last keys for dk
    and dv, where the values are smallest)."""
    broken = got.clone()
    broken[:, -tile:] = 0
    keys = ("max_abs_err", "rel_l2", "worst_tile_rel_l2", "elem_atol_rms_needed")
    out = agreement(got, ref, tol, tile)
    for name, x in (("low_precision", low), ("last_tile_zeroed", broken)):
        reading = agreement(x, ref, tol, tile)
        out[name] = {**{k: reading[k] for k in keys}, "rejected": not reading["ok"]}
    out["yardsticks_rejected"] = all(out[n]["rejected"] for n in
                                     ("low_precision", "last_tile_zeroed"))
    return out


def phase_fwd_kernel(gen: torch.Generator):
    """K1 vs its plain version; returns {shape: record}."""
    from deepspeed_tpu_torch.ops.kernels.flash_attention import (
        flash_attention, flash_attention_reference)

    records = {}
    for shape in FWD_SHAPES:
        B, S, Hq, Hkv, hd, dtype, causal = shape
        slices = _slices(shape)
        q, k, v = _inputs(gen, shape, 3)
        parts = _parts(slices, q, k, v)
        with torch.inference_mode():
            out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
            torch.cuda.synchronize()
            ref, ref_lse = flash_attention_reference(*parts[0], causal, None, True)
            if slices is not None:
                lo, hi = slices[0]
                out, lse = _heads(out, lo, hi), _heads(lse, lo, hi, dim=1)
            tol = AGREE_TOL["fwd"][dtype]
            agree = compare(out, ref, plain_low_precision(*parts[0], causal), tol)
            lse_err = (lse - ref_lse).abs().max().item()
            del out, lse, ref, ref_lse
            kernel_ms = time_ms(lambda: flash_attention(q, k, v, causal=causal))
            reps, warm = (20, 3) if slices is None else (5, 1)
            plain_ms = time_ms(
                lambda: [flash_attention_reference(*p, causal) for p in parts],
                reps=reps, warmup=warm)
            del parts
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=Hq != Hkv))
        bound, bound_by = attention_bound_ms(*shape)
        rec = {"phase": "kernel", "name": "flash_attention_fwd",
               "shape": _shape_dict(shape, slices),
               "max_abs_err": agree["max_abs_err"], "out": agree,
               "tol": tol, "lse_max_abs_err": lse_err,
               "lse_atol": LSE_ATOL, "ms": kernel_ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound, "bound_by": bound_by,
               "bound_share": bound / kernel_ms}
        emit(rec)
        check(agree["ok"] and lse_err <= LSE_ATOL,
              f"flash_attention_fwd disagrees with its plain version at "
              f"{rec['shape']}: {agree}, lse err {lse_err}")
        check(agree["yardsticks_rejected"],
              f"the flash_attention_fwd gate passed a yardstick at "
              f"{rec['shape']}: {agree}")
        records[shape] = rec
        del q, k, v
        free_memory()
    return records


def phase_bwd_kernels(gen: torch.Generator):
    """K2 and K3 vs their plain versions on the residuals of a plain
    forward; library: the backward of scaled_dot_product_attention (dq, dk
    and dv in one call).  Returns {shape: (K2 record, K3 record)}."""
    from deepspeed_tpu_torch.ops.kernels.flash_attention import (
        flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dkv_reference,
        flash_attention_bwd_dq, flash_attention_bwd_dq_reference)

    records = {}
    for shape in BWD_SHAPES:
        B, S, Hq, Hkv, hd, dtype, causal = shape
        slices = _slices(shape)
        q, k, v, do = _inputs(gen, shape, 4)
        with torch.inference_mode():
            out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
            delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
            del out
            args = (q, k, v, do, lse, delta, causal)
            dq = flash_attention_bwd_dq(*args)
            dk, dv = flash_attention_bwd_dkv(*args)
            torch.cuda.synchronize()
            # plain versions on the same residuals, head slice by head slice
            parts = _parts(slices, q, k, v, do, lse, delta)
            if slices is not None:   # MHA: q and kv heads slice alike
                lo, hi = slices[0]
                dq, dk, dv = (_heads(x, lo, hi) for x in (dq, dk, dv))
            low = plain_low_precision(*parts[0][:3], causal, *parts[0][3:])
            rq = flash_attention_bwd_dq_reference(*parts[0], causal)
            tol = AGREE_TOL["bwd"][dtype]
            agree = {"dq": compare(dq, rq, low[0], tol)}
            del rq
            rk, rv = flash_attention_bwd_dkv_reference(*parts[0], causal)
            agree["dk"] = compare(dk, rk, low[1], tol)
            agree["dv"] = compare(dv, rv, low[2], tol)
            del rk, rv, dq, dk, dv, low
            free_memory()
            reps, warm = (20, 3) if slices is None else (5, 1)
            dq_ms = time_ms(lambda: flash_attention_bwd_dq(*args))
            dkv_ms = time_ms(lambda: flash_attention_bwd_dkv(*args))
            dq_plain = time_ms(lambda: [flash_attention_bwd_dq_reference(*p, causal)
                                        for p in parts], reps=reps, warmup=warm)
            dkv_plain = time_ms(lambda: [flash_attention_bwd_dkv_reference(*p, causal)
                                         for p in parts], reps=reps, warmup=warm)
            del parts
        free_memory()
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                  enable_gqa=Hq != Hkv)
        dot = do.transpose(1, 2)
        library_ms = time_ms(lambda: torch.autograd.grad(
            sdpa_out, (qt, kt, vt), dot, retain_graph=True))
        del qt, kt, vt, sdpa_out, dot
        pair = []
        for name, kernel, ms, plain_ms, outs in (
                ("flash_attention_bwd_dq", "dq", dq_ms, dq_plain, ("dq",)),
                ("flash_attention_bwd_dkv", "dkv", dkv_ms, dkv_plain, ("dk", "dv"))):
            bound, bound_by = attention_bound_ms(*shape, kernel=kernel)
            rec = {"phase": "kernel", "name": name,
                   "shape": _shape_dict(shape, slices),
                   "max_abs_err": max(agree[o]["max_abs_err"] for o in outs),
                   **{o: agree[o] for o in outs}, "tol": tol,
                   "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                   "library_what": "scaled_dot_product_attention backward "
                                   "(dq, dk, dv in one call): compare with "
                                   "K2 + K3",
                   "bound_ms": bound, "bound_by": bound_by,
                   "bound_share": bound / ms}
            emit(rec)
            check(all(agree[o]["ok"] for o in outs),
                  f"{name} disagrees with its plain version at {rec['shape']}: "
                  f"{ {o: agree[o] for o in outs} }")
            check(all(agree[o]["yardsticks_rejected"] for o in outs),
                  f"the {name} gate passed a yardstick at {rec['shape']}: "
                  f"{ {o: agree[o] for o in outs} }")
            pair.append(rec)
        records[shape] = tuple(pair)
        del q, k, v, do, lse, delta, args
        free_memory()
    # fp32 gradients on the card are refused, never run on the plain version
    f = torch.randn((1, 128, 2, 64), device="cuda").requires_grad_()
    try:
        flash_attention(f, f, f)
    except NotImplementedError:
        pass
    else:
        raise RuntimeError("an fp32 flash gradient on CUDA did not raise")
    return records


def phase_decode_yardstick():
    """K4 (the retired Pallas decode kernel, not yet ported): its bound at
    the generate phase's decode shape and the library's time there, a
    query of one token against a [B, T, H, hd] cache (T rounded up to a
    multiple of 128, as K4 requires) with an int mask."""
    B, Hq, Hkv, hd = len(GEN_PROMPTS), SERVE_SHAPE[2], SERVE_SHAPE[3], SERVE_SHAPE[4]
    tokens = max(GEN_PROMPTS) + GEN_NEW
    T = -(-tokens // 128) * 128
    g = torch.Generator(device="cuda").manual_seed(7)
    q = torch.randn((B, Hq, 1, hd), generator=g, device="cuda").bfloat16()
    k, v = (torch.randn((B, Hkv, T, hd), generator=g, device="cuda").bfloat16()
            for _ in range(2))
    mask = torch.zeros((B, 1, 1, T), dtype=torch.bool, device="cuda")
    mask[..., :tokens] = True
    with torch.inference_mode():
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=Hq != Hkv))
    flops = 4.0 * B * Hq * T * hd
    nbytes = 2 * (2 * B * Hq * hd + 2 * B * T * Hkv * hd) + 4 * B * T
    bound, bound_by = _bound(flops, nbytes, torch.bfloat16)
    emit({"phase": "decode_yardstick", "kernel": "K4 flash_decode (not ported)",
          "shape": {"B": B, "Hq": Hq, "Hkv": Hkv, "hd": hd, "T": T,
                    "valid_tokens": tokens, "dtype": "bfloat16"},
          "bound_ms": bound, "bound_by": bound_by, "library_ms": library_ms,
          "library_what": "scaled_dot_product_attention, query length 1, bool mask"})


def kernel_counts() -> tuple:
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa

    return (fa.flash_attention.launches, fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches)


def reset_counts() -> None:
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa

    for fn in (fa.flash_attention, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkv):
        fn.launches = 0


def _train_engine(seed, S, attn_impl="auto", fp32=False, params=None):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import CausalLM

    config = {**TRAIN_CONFIG, "seed": seed}
    if fp32:
        config["bf16"] = {"enabled": False}
        config["data_types"] = {"grad_accum_dtype": "fp32"}
    model = CausalLM(TRAIN_MODEL, max_seq_len=S, attn_impl=attn_impl,
                     dtype=torch.float32 if fp32 else torch.bfloat16)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=config,
                                                params=params)
    return model, engine


def phase_train(seed: int, profile: bool, kernel_ms: dict):
    """The main path: ``initialize`` -> ``train_batch`` at bench.py's
    defaults.  Returns the launches of the timed run."""
    S = TRAIN_SHAPE[1]
    t0 = time.perf_counter()
    model, engine = _train_engine(seed, S)
    cfg = model.config
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    batch = {"input_ids": torch.randint(0, cfg.vocab_size, (1, S), generator=gen,
                                        device="cuda")}
    L = cfg.num_layers
    per_step = (2 * L, L, L)
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    # the main path: counts to 0 just before, read just after
    reset_counts()
    for _ in range(WARM_STEPS + TIMED_STEPS):
        before = kernel_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = float(engine.train_batch(batch=batch))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        losses.append(loss)
        got = tuple(a - b for a, b in zip(kernel_counts(), before))
        check(got == per_step, f"a train step launched K1/K2/K3 {got} times, "
                               f"expected {per_step}")
    launches = kernel_counts()
    timed = step_s[WARM_STEPS:]
    med = statistics.median(timed)
    flops_per_token = 6.0 * model.param_count + 12.0 * L * cfg.hidden_size * S
    tflops = S / med * flops_per_token / 1e12
    attn_ms = L * (2 * kernel_ms["fwd"] + kernel_ms["dq"] + kernel_ms["dkv"])
    rec = {"phase": "train", "model": TRAIN_MODEL, "params": model.param_count,
           "layers": L, "S": S, "micro_batch": 1, "gas": 1,
           "config": TRAIN_CONFIG, "remat_policy": cfg.remat_policy,
           "init_s": init_s, "step_s": step_s, "warm_steps": WARM_STEPS,
           "median_step_s": med, "tokens_per_s": S / med,
           "model_flops_per_token": flops_per_token, "model_tflops": tflops,
           "mfu": tflops * 1e12 / PEAK_FLOPS[torch.bfloat16],
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "losses": losses, "grad_norm": engine.get_global_grad_norm(),
           "launches": dict(zip(("K1", "K2", "K3"), launches)),
           "launches_per_step": dict(zip(("K1", "K2", "K3"), per_step)),
           "attention_kernels_ms_per_step_from_kernel_phase": attn_ms,
           "attention_share_of_step": attn_ms / 1e3 / med}
    emit(rec)
    check(all(math.isfinite(x) for x in losses), f"non-finite training loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall on a repeated batch: {losses}")
    if profile:
        profile_step("train_step", lambda: engine.train_batch(batch=batch))
    del engine, model, batch
    free_memory()
    return launches


def phase_train_parity(seed: int):
    """3 steps from one set of weights on one batch at S=2048 through the
    kernels (attn_impl="auto") and through the plain branch ("xla"), both
    bf16, and through an fp32 engine on the plain branch."""
    from deepspeed_tpu_torch.models import CausalLM

    S = PARITY_S
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    base = CausalLM(TRAIN_MODEL, max_seq_len=S)
    params = base.init_fn(gen)
    batch = {"input_ids": torch.randint(0, base.config.vocab_size, (1, S),
                                        generator=gen, device="cuda")}
    L = base.config.num_layers
    runs = {}
    for label, impl, fp32 in (("kernel", "auto", False), ("plain", "xla", False),
                              ("fp32", "xla", True)):
        _, engine = _train_engine(seed, S, impl, fp32, params=params)
        before = kernel_counts()
        losses, norms = [], []
        for _ in range(PARITY_STEPS):
            losses.append(float(engine.train_batch(batch=batch)))
            norms.append(engine.get_global_grad_norm())
        got = tuple(a - b for a, b in zip(kernel_counts(), before))
        want = ((2 * L * PARITY_STEPS, L * PARITY_STEPS, L * PARITY_STEPS)
                if label == "kernel" else (0, 0, 0))
        check(got == want, f"{label} run launched K1/K2/K3 {got}, expected {want}")
        runs[label] = {"losses": losses, "grad_norms": norms, "launches": got}
        del engine
        free_memory()

    def rel(a, b):
        return abs(a - b) / abs(b)

    k, p, f = runs["kernel"], runs["plain"], runs["fp32"]
    rec = {"phase": "train_parity", "model": TRAIN_MODEL, "S": S,
           "steps": PARITY_STEPS, **{f"{n}_{key}": r[key] for n, r in runs.items()
                                     for key in ("losses", "grad_norms")},
           "loss_rel_diff_kernel_vs_plain": [rel(a, b) for a, b in
                                             zip(k["losses"], p["losses"])],
           "grad_norm_rel_diff_kernel_vs_plain": [rel(a, b) for a, b in
                                                  zip(k["grad_norms"], p["grad_norms"])],
           "loss_rel_diff_vs_fp32": {
               "kernel": [rel(a, b) for a, b in zip(k["losses"], f["losses"])],
               "plain": [rel(a, b) for a, b in zip(p["losses"], f["losses"])]},
           "grad_norm_rel_diff_vs_fp32": {
               "kernel": [rel(a, b) for a, b in zip(k["grad_norms"], f["grad_norms"])],
               "plain": [rel(a, b) for a, b in zip(p["grad_norms"], f["grad_norms"])]},
           "gates": {"loss_rtol": PARITY_LOSS_RTOL,
                     "grad_norm_rtol": PARITY_GRAD_NORM_RTOL,
                     "vs_fp32": "kernel path no further than the plain branch"}}
    emit(rec)
    check(max(rec["loss_rel_diff_kernel_vs_plain"]) <= PARITY_LOSS_RTOL,
          f"kernel and plain loss trajectories differ: {rec}")
    check(max(rec["grad_norm_rel_diff_kernel_vs_plain"]) <= PARITY_GRAD_NORM_RTOL,
          f"kernel and plain gradient norms differ: {rec}")
    for key in ("loss_rel_diff_vs_fp32", "grad_norm_rel_diff_vs_fp32"):
        check(max(rec[key]["kernel"]) <= max(rec[key]["plain"]),
              f"the kernel path strays further from fp32 than the plain "
              f"branch ({key}): {rec}")
    del params, batch
    free_memory()


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


def profile_step(label: str, fn) -> None:
    """One warm call of ``fn`` under ``torch.profiler``: device time by
    kernel (top 12), K1/K2/K3 time and the device's busy share of the wall
    time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_us, by_name = device_activity(prof.events())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])

    def total_ms(tag):
        return sum(t for name, (t, _) in by_name.items() if tag in name) / 1e3

    flash = {"K1": total_ms("flash_fwd"), "K2": total_ms("flash_bwd_dq"),
             "K3": total_ms("flash_bwd_dkv")}
    emit({"phase": "profile", "what": label, "wall_ms": wall_ms,
          "device_busy_ms": busy_us / 1e3,
          "device_busy_share": busy_us / 1e3 / wall_ms,
          "flash_kernels_ms": flash,
          "flash_kernels_share_of_wall": {k: v / wall_ms for k, v in flash.items()},
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
    emit({"phase": "init", "model": "llama2-7b", "params": model.param_count,
          "layers": cfg.num_layers, "seconds": time.perf_counter() - t0,
          "weights_gb": torch.cuda.memory_allocated() / 1e9})

    S = SERVE_SHAPE[1]
    tokens = torch.randint(0, cfg.vocab_size, (1, S), generator=gen,
                           device="cuda")
    # the serving path: counts to 0 just before, read just after
    reset_counts()
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

    lengths = GEN_PROMPTS
    ids = torch.zeros((4, max(lengths)), dtype=torch.long)
    mask = torch.zeros((4, max(lengths)), dtype=torch.bool)
    cpu_gen = torch.Generator().manual_seed(seed + 1)
    for i, n in enumerate(lengths):
        ids[i, :n] = torch.randint(0, cfg.vocab_size, (n,), generator=cpu_gen)
        mask[i, :n] = True
    new = GEN_NEW
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
        ids128 = tokens[:, :128].repeat(4, 1)
        profile_step("forward", lambda: engine.forward(tokens))
        profile_step("generate_2_tokens",
                     lambda: engine.generate(ids128, max_new_tokens=2))
    del engine, params
    free_memory()
    return launches


def _kernel_entry(name, source, replaces, launches, rec, **extra):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"], **extra}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also profile one train step, one forward and one "
                         "decode step")
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
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    fwd = phase_fwd_kernel(gen)
    bwd = phase_bwd_kernels(gen)
    phase_decode_yardstick()
    k1, (k2, k3) = fwd[TRAIN_SHAPE], bwd[TRAIN_SHAPE]
    train_launches = phase_train(args.seed, args.profile,
                                 {"fwd": k1["ms"], "dq": k2["ms"], "dkv": k3["ms"]})
    phase_train_parity(args.seed)
    serve_launches = phase_serving(args.seed, args.profile)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    src = "deepspeed_tpu_torch/ops/csrc/"
    jax_src = "deepspeed_tpu/ops/pallas/flash_attention.py"
    emit({"kernels": [
        _kernel_entry("flash_attention_fwd", src + "flash_attention_fwd.cu",
                      jax_src + ":74", train_launches[0], k1,
                      launches_serving_forward=serve_launches,
                      serving_shape_ms=fwd[SERVE_SHAPE]["ms"]),
        _kernel_entry("flash_attention_bwd_dq", src + "flash_attention_bwd.cu",
                      jax_src + ":189", train_launches[1], k2),
        _kernel_entry("flash_attention_bwd_dkv", src + "flash_attention_bwd.cu",
                      jax_src + ":236", train_launches[2], k3)]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
