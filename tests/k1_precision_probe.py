"""Where K1's per-element error against its plain version comes from, on a
CUDA card.

``chip_smoke.py``'s phase ``kernel`` holds K1 (bf16) to its fp32 plain
version per element as ``|err| <= elem_rtol*|ref| + elem_atol_rms*rms(ref)``.
This draws the phase's inputs the way it does (one generator from the
seed, ``_inputs`` per shape in order) and, at each bf16 causal shape of
16384 rows or fewer, prints the ``elem_atol_rms`` that three outputs need:
the kernel, SDPA, and a plain reference that keeps the scores and the
softmax statistics in fp32 but rounds P to bf16 before the PV product, as
the kernel's design does. Equal numbers mean the kernel's error is its
design's rounding, not a fault. ``--with-b2`` inserts (2, 16384, 14x128)
after CLEANED_SHAPE, the order that phase kernel ran in when the
autotuner's space held micro-batch 2.

    python3 tests/k1_precision_probe.py [--with-b2] > out.jsonl
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from deepspeed_tpu_torch.ops.kernels import flash_attention as fa  # noqa: E402

B2_SHAPE = (2, 16384, 14, 14, 128, torch.bfloat16, True)


def needed(x, ref, rms: float, rtol: float) -> float:
    d = (x.float() - ref.float()).abs() - rtol * ref.float().abs()
    return float(d.clamp(min=0).max() / rms)


def p_bf16_reference(q, k, v):
    """Causal attention with fp32 scores, max and sum, P rounded to bf16
    for PV (summed in fp32), the output rounded to bf16."""
    S, hd = q.shape[1], q.shape[3]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * hd ** -0.5
    keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.exp(s.masked_fill(~keep, float("-inf"))
                  - s.masked_fill(~keep, float("-inf")).amax(-1, keepdim=True))
    del s
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(torch.bfloat16).float(), v.float())
    return (o / p.sum(-1, keepdim=True)).transpose(1, 2).to(torch.bfloat16)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--with-b2", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase_build()
    shapes = list(cs.FWD_SHAPES)
    if args.with_b2:
        shapes.insert(shapes.index(cs.CLEANED_SHAPE) + 1, B2_SHAPE)
    print(json.dumps({"nvidia_smi": cs.nvidia_smi_line()}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    for shape in shapes:
        q, k, v = cs._inputs(gen, shape, 3)       # every shape draws, as phase kernel
        B, S, Hq, Hkv, hd, dtype, causal = shape
        if dtype != torch.bfloat16 or not causal or Hq != Hkv or S > cs.LONG_ROWS:
            continue
        sl = cs._slices(shape)
        part = cs._parts(sl, q, k, v)[0]
        rtol = cs.AGREE_TOL["fwd"][dtype]["elem_rtol"]
        with torch.inference_mode():
            got = fa.flash_attention(q, k, v, causal=True)
            got = got if sl is None else cs._cut(got, sl[0])
            ref = fa.flash_attention_reference(*part, True)
            rms = float(ref.float().pow(2).mean().sqrt())
            outs = {"kernel": got,
                    "sdpa": F.scaled_dot_product_attention(
                        *(x.transpose(1, 2) for x in part), is_causal=True).transpose(1, 2),
                    "p_bf16_reference": p_bf16_reference(*part)}
            err = (got.float() - ref.float()).abs() - rtol * ref.float().abs()
            at = torch.unravel_index(err.flatten().argmax(), err.shape)
            print(json.dumps({
                "shape": cs._shape_dict(shape, sl), "rms_ref": rms,
                "limit": cs.fwd_tol(dtype, S, causal)["elem_atol_rms"],
                "needed": {n: needed(x, ref, rms, rtol) for n, x in outs.items()},
                "worst_element": {"row": int(at[1]), "plain": float(ref.float()[at]),
                                  **{n: float(x.float()[at]) for n, x in outs.items()}}}),
                flush=True)
        del q, k, v, part, got, ref, outs, err
        cs.free_memory()
    return 0


if __name__ == "__main__":
    sys.exit(main())
