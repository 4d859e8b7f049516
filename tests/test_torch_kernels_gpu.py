"""The port's CUDA kernels against their plain PyTorch versions, on the card
(K1-K3 the flash-attention kernels, unmasked and in their block-sparse
``block_mask`` mode, K4 the paged decode attention and its CUDA-graph
capture in the serving engine).

Marked ``gpu``: they skip on a host without a CUDA card.  This file imports
no jax (the GPU machine has none), so it runs there on its own:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py -q

(``-rP`` also shows each comparison's readings.)
"""
import json

import pytest
import torch

from chip_smoke import (AGREE_TOL, DECODE_CASES, DECODE_INT8_CASES, DECODE_TOL, LSE_ATOL,
                        _decode_case, agreement, decode_compare, decode_lengths,
                        decode_low_precision, quantize_pools, verify_rows)
from deepspeed_tpu_torch.ops import sparse_attention as sa
from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
from deepspeed_tpu_torch.ops.kernels.decode_attention import (
    decode_attention, decode_attention_reference)
from deepspeed_tpu_torch.ops.kernels.flash_attention import (
    attended, flash_attention, flash_attention_bwd_dkv,
    flash_attention_bwd_dkv_reference, flash_attention_bwd_dq,
    flash_attention_bwd_dq_reference, flash_attention_reference)

# bf16 autograd against an fp32 autograd of the plain forward, which rounds
# neither P nor dS: worst tile 3.0e-3 and per-element need 0.033 on the H100
VS_FP32_TOL = {"tile_rel": 1e-2, "elem_rtol": 2e-2, "elem_atol_rms": 0.1}


def assert_agrees(got, ref, tol, dead=None):
    """``chip_smoke.agreement``: the worst 128-row tile's relative error and
    a per-element bound, within ``tol`` (and exact zeros on the ``dead``
    rows).  The readings are printed (shown with ``-rP``) for setting the
    limits."""
    reading = agreement(got, ref, tol, dead=dead)
    print(json.dumps(reading))
    assert reading["ok"], reading


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run `python -m pytest --noconftest "
                    "-m gpu tests/test_torch_kernels_gpu.py` on the GPU machine")
    return torch.device("cuda")


def _inputs(B, S, Hq, Hkv, hd, dt, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn((B, S, H, hd), generator=g, device="cuda").to(dt)
                 for H in (Hq, Hkv, Hkv, Hq))


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_forward_matches_plain_version(cuda, dtype, hd, causal):
    dt = getattr(torch, dtype)
    q, k, v, _ = _inputs(2, 256, 8, 2, hd, dt)
    with torch.inference_mode():
        before = flash_attention.launches
        out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        ref, ref_lse = flash_attention_reference(q, k, v, causal, None, True)
    assert_agrees(out, ref, AGREE_TOL["fwd"][dt])
    torch.testing.assert_close(lse, ref_lse, atol=LSE_ATOL, rtol=0)


# K1's TMA/wgmma pipeline: one tile (fewer tiles than ring stages), many
# more tiles than stages, GQA 32/8 over two batches; hd 64/128, causal and
# full, bf16 and fp16
PIPELINE_CASES = [
    (1, 128, 4, 4, 128, "bfloat16", True),
    (1, 128, 4, 4, 64, "float16", False),
    (1, 2048, 4, 4, 128, "bfloat16", True),
    (1, 2048, 4, 4, 64, "bfloat16", False),
    (1, 2048, 4, 4, 128, "float16", False),
    (1, 2048, 4, 4, 64, "float16", True),
    (2, 1024, 32, 8, 128, "bfloat16", True),
    (2, 1024, 32, 8, 64, "bfloat16", False),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", PIPELINE_CASES, ids=lambda c: f"{c[5]}-hd{c[4]}-"
                         f"{'causal' if c[6] else 'full'}-B{c[0]}S{c[1]}-{c[2]}x{c[3]}")
def test_flash_forward_pipeline_matches_plain_version(cuda, case):
    B, S, Hq, Hkv, hd, dtype, causal = case
    dt = getattr(torch, dtype)
    q, k, v, _ = _inputs(B, S, Hq, Hkv, hd, dt, seed=S + hd)
    with torch.inference_mode():
        out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
        torch.cuda.synchronize()
        ref, ref_lse = flash_attention_reference(q, k, v, causal, None, True)
    assert out.dtype == dt and out.shape == q.shape
    assert_agrees(out, ref, AGREE_TOL["fwd"][dt])
    torch.testing.assert_close(lse, ref_lse, atol=LSE_ATOL, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (8, 2)])
def test_flash_backward_kernels_match_plain_versions(cuda, Hq, Hkv, hd, dtype,
                                                     causal):
    dt = getattr(torch, dtype)
    q, k, v, do = _inputs(2, 384, Hq, Hkv, hd, dt, seed=hd + Hq)
    with torch.inference_mode():
        out, lse = flash_attention_reference(q, k, v, causal, None, True)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        n2, n3 = flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal)
        torch.cuda.synchronize()
        assert flash_attention_bwd_dq.launches == n2 + 1
        assert flash_attention_bwd_dkv.launches == n3 + 1
        rq = flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, causal)
        rk, rv = flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta, causal)
    for got, ref in ((dq, rq), (dk, rk), (dv, rv)):
        assert got.dtype == dt and got.shape == ref.shape
        assert_agrees(got, ref, AGREE_TOL["bwd"][dt])


@pytest.mark.gpu
def test_flash_autograd_launches_each_kernel_once(cuda):
    q, k, v, do = _inputs(1, 256, 8, 2, 128, torch.bfloat16, seed=3)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    counts = (flash_attention.launches, flash_attention_bwd_dq.launches,
              flash_attention_bwd_dkv.launches)
    out = flash_attention(q, k, v)
    out.backward(do.transpose(1, 2).contiguous().transpose(1, 2))   # strided dO
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_bwd_dq.launches,
            flash_attention_bwd_dkv.launches) == tuple(c + 1 for c in counts)
    qr, kr, vr = (x.detach().float().requires_grad_() for x in (q, k, v))
    flash_attention_reference(qr, kr, vr).backward(do.float())
    for got, ref in ((q.grad, qr.grad), (k.grad, kr.grad), (v.grad, vr.grad)):
        assert_agrees(got, ref, VS_FP32_TOL)


@pytest.mark.gpu
def test_flash_forward_refuses_what_it_cannot_run(cuda):
    q = torch.randn((1, 128, 2, 128), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="block grid"):
        flash_attention(q, q, q, block_mask=torch.ones((2, 2), dtype=torch.bool))
    with pytest.raises(NotImplementedError, match="return_lse"):
        flash_attention(q, q, q, block_mask=torch.ones((1, 1), dtype=torch.bool),
                        return_lse=True)
    # fp32 gradients run through K1-K3 (they were refused before the fp32
    # backward kernels); fp64 ones raise
    f = q.float().requires_grad_()
    counts = (flash_attention.launches, flash_attention_bwd_dq.launches,
              flash_attention_bwd_dkv.launches)
    flash_attention(f, f, f).sum().backward()
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_bwd_dq.launches,
            flash_attention_bwd_dkv.launches) == tuple(c + 1 for c in counts)
    assert torch.isfinite(f.grad).all()
    lse = torch.zeros((1, 2, 128), device="cuda")
    with pytest.raises(TypeError, match="float32/float16/bfloat16"):
        flash_attention_bwd_dq(q.double(), q.double(), q.double(), q.double(), lse, lse)
    with pytest.raises(TypeError):
        flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="contiguous"):
        x = torch.randn((1, 2, 128, 128), device="cuda",
                        dtype=torch.bfloat16).transpose(1, 2)
        flash_attention(x, x, x)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd_dkv(q, q, q, q, lse[:, :1], lse)


# ---------------------------------------------------------------------------
# The block-sparse (masked) mode of K1-K3
# ---------------------------------------------------------------------------

# (B, S, Hq, Hkv, hd, dtype, causal, block_q, block_k): mask blocks below,
# at and above the kernels' tiles, square and not
MASK_CASES = [
    (1, 512, 8, 2, 128, "bfloat16", True, 64, 64),
    (2, 384, 4, 4, 64, "bfloat16", False, 32, 32),
    (1, 512, 4, 4, 128, "float16", True, 256, 128),
    (1, 512, 8, 2, 64, "bfloat16", False, 64, 16),
    (1, 384, 8, 2, 128, "float32", True, 32, 64),
]


def _block_mask(S, bq, bk, seed):
    """Half the blocks live, block row 1 dead (no live key) and key block 2
    seen by no query."""
    g = torch.Generator().manual_seed(seed)
    mask = torch.rand((S // bq, S // bk), generator=g) < 0.5
    mask[:, 0] = True
    mask[1] = False
    mask[:, 2] = False
    return mask


def _dead(S, causal, mask):
    keep = attended(S, causal, mask, "cuda")
    return ~keep.any(-1), ~keep.any(0)


@pytest.mark.gpu
@pytest.mark.parametrize("case", MASK_CASES, ids=lambda c: f"{c[5]}-hd{c[4]}-"
                         f"{'causal' if c[6] else 'full'}-b{c[7]}x{c[8]}-{c[2]}x{c[3]}")
def test_masked_kernels_match_plain_versions(cuda, case):
    B, S, Hq, Hkv, hd, dtype, causal, bq, bk = case
    dt = getattr(torch, dtype)
    q, k, v, do = _inputs(B, S, Hq, Hkv, hd, dt, seed=bq + bk)
    mask = _block_mask(S, bq, bk, seed=hd)
    dead_q, dead_k = _dead(S, causal, mask)
    scale = hd ** -0.5
    with torch.inference_mode():
        counts = (flash_attention.launches, flash_attention_bwd_dq.launches,
                  flash_attention_bwd_dkv.launches)
        out, lse = fa._forward(q, k, v, causal, scale, mask)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, do, lse, delta, causal, scale, mask)
        dq = flash_attention_bwd_dq(*args)
        dk, dv = flash_attention_bwd_dkv(*args)
        torch.cuda.synchronize()
        assert (flash_attention.launches, flash_attention_bwd_dq.launches,
                flash_attention_bwd_dkv.launches) == tuple(c + 1 for c in counts)
        ref, ref_lse = flash_attention_reference(q, k, v, causal, scale, True, mask)
        rq = flash_attention_bwd_dq_reference(*args)
        rk, rv = flash_attention_bwd_dkv_reference(*args)
    assert_agrees(out, ref, AGREE_TOL["fwd"][dt], dead_q)
    torch.testing.assert_close(lse, ref_lse, atol=LSE_ATOL, rtol=0)
    assert (lse[:, :, dead_q] == -1e30).all()
    for got, want, dead in ((dq, rq, dead_q), (dk, rk, dead_k), (dv, rv, dead_k)):
        assert got.dtype == dt and got.shape == want.shape
        assert_agrees(got, want, AGREE_TOL["bwd"][dt], dead)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("block", [32, 64])
@pytest.mark.parametrize("causal", [True, False])
def test_masked_forward_partly_live_tiles(cuda, causal, block, hd):
    """Mask blocks below K1's 128 x 128 tile: most visited tiles are partly
    live, and a warpgroup or a whole query tile may have no live group."""
    S = 1024
    q, k, v, _ = _inputs(2, S, 8, 2, hd, torch.bfloat16, seed=block + hd)
    mask = _block_mask(S, block, block, seed=block)
    dead_q, _ = _dead(S, causal, mask)
    with torch.inference_mode():
        out, lse = fa._forward(q, k, v, causal, hd ** -0.5, mask)
        torch.cuda.synchronize()
        ref, ref_lse = flash_attention_reference(q, k, v, causal, None, True, mask)
    assert_agrees(out, ref, AGREE_TOL["fwd"][torch.bfloat16], dead_q)
    torch.testing.assert_close(lse, ref_lse, atol=LSE_ATOL, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_masked_forward_dead_rows(cuda, dtype):
    """chip_smoke.py's raw mask with dead block rows (half of a 128-row
    tile each) and a key block no query sees: exact zeros, lse -1e30."""
    from chip_smoke import dead_rows_mask

    S, dt = 2048, getattr(torch, dtype)
    q, k, v, _ = _inputs(1, S, 8, 8, 128, dt, seed=21)
    mask = torch.from_numpy(dead_rows_mask(S))
    dead_q, _ = _dead(S, True, mask)
    assert int(dead_q.sum()) >= 128
    with torch.inference_mode():
        out, lse = fa._forward(q, k, v, True, 128 ** -0.5, mask)
        torch.cuda.synchronize()
        ref, ref_lse = flash_attention_reference(q, k, v, True, None, True, mask)
    assert_agrees(out, ref, AGREE_TOL["fwd"][dt], dead_q)
    assert (lse[:, :, dead_q] == -1e30).all()
    torch.testing.assert_close(lse, ref_lse, atol=LSE_ATOL, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
def test_masked_fp32_forward_matches_plain_version(cuda, causal):
    """The CUDA-core fp32 variant of K1 walks its own 64 x 64 tile table."""
    q, k, v, _ = _inputs(1, 384, 4, 2, 128, torch.float32, seed=5)
    mask = _block_mask(384, 32, 64, seed=6)
    dead_q, _ = _dead(384, causal, mask)
    with torch.inference_mode():
        out = flash_attention(q, k, v, causal=causal, block_q=32, block_k=64,
                              block_mask=mask)
        ref = flash_attention_reference(q, k, v, causal, None, False, mask)
    assert_agrees(out, ref, AGREE_TOL["fwd"][torch.float32], dead_q)


# fp32 training through the kernels (attn_impl="auto" at S >= 2048) against
# the fp32 plain branch ("xla"): summation order only (9.5e-8 in loss,
# 4.7e-7 in gradient norm on the H100).  The limits sit between that gap
# and the yardstick each run must exceed, the bf16 kernel path's distance
# from the same fp32 run (1.1e-4 / 3.9e-4).
FP32_TRAIN_LOSS_RTOL = 1e-5
FP32_TRAIN_GRAD_NORM_RTOL = 1e-4


def _train(dtype, attn_impl, S, steps=3):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import CausalLM

    model = CausalLM("tiny", hidden_size=256, intermediate_size=512, num_heads=4,
                     num_layers=2, max_seq_len=S, attn_impl=attn_impl, dtype=dtype)
    params = model.init_fn(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    bf16 = dtype == torch.bfloat16
    config = {"train_micro_batch_size_per_gpu": 1, "gradient_accumulation_steps": 1,
              "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
              "bf16": {"enabled": bf16},
              "data_types": {"grad_accum_dtype": "bf16" if bf16 else "fp32"},
              "steps_per_print": 10 ** 9, "seed": 0}
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=config, params=params)
    g = torch.Generator(device="cuda").manual_seed(1)
    batch = {"input_ids": torch.randint(0, 256, (1, S), generator=g, device="cuda")}
    counts = (flash_attention.launches, flash_attention_bwd_dq.launches,
              flash_attention_bwd_dkv.launches)
    losses, norms = [], []
    for _ in range(steps):
        losses.append(float(engine.train_batch(batch=batch)))
        norms.append(engine.get_global_grad_norm())
    launches = tuple(n - c for n, c in zip((flash_attention.launches,
                                            flash_attention_bwd_dq.launches,
                                            flash_attention_bwd_dkv.launches), counts))
    return losses, norms, launches


@pytest.mark.gpu
def test_fp32_training_through_the_kernels_matches_plain_branch(cuda):
    S, steps = 2048, 3
    kernel = _train(torch.float32, "auto", S, steps)
    plain = _train(torch.float32, "xla", S, steps)
    bf16 = _train(torch.bfloat16, "auto", S, steps)
    assert kernel[2] == (2 * steps, 2 * steps, 2 * steps)   # 2 layers, no remat
    assert plain[2] == (0, 0, 0)

    def rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    reading = {"loss": rel(kernel[0], plain[0]), "grad_norm": rel(kernel[1], plain[1]),
               "bf16_loss": rel(bf16[0], plain[0]), "bf16_grad_norm": rel(bf16[1], plain[1])}
    print(json.dumps(reading))
    assert all(map(lambda x: x == x and abs(x) < float("inf"), kernel[0]))
    assert reading["loss"] <= FP32_TRAIN_LOSS_RTOL, reading
    assert reading["grad_norm"] <= FP32_TRAIN_GRAD_NORM_RTOL, reading
    # the yardstick: the limits reject the bf16 kernel path
    assert reading["bf16_loss"] > FP32_TRAIN_LOSS_RTOL or \
        reading["bf16_grad_norm"] > FP32_TRAIN_GRAD_NORM_RTOL, reading


@pytest.mark.gpu
def test_sparse_self_attention_launches_each_kernel_once(cuda):
    q, k, v, do = _inputs(1, 1024, 8, 2, 128, torch.bfloat16, seed=8)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    layer = sa.SparseSelfAttention(sa.BSLongformerSparsityConfig(block=64))
    counts = (flash_attention.launches, flash_attention_bwd_dq.launches,
              flash_attention_bwd_dkv.launches)
    layer(q, k, v).backward(do)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_bwd_dq.launches,
            flash_attention_bwd_dkv.launches) == tuple(c + 1 for c in counts)
    mask = layer.layout(1024)
    qr, kr, vr = (x.detach().float().requires_grad_() for x in (q, k, v))
    flash_attention_reference(qr, kr, vr, True, None, False, mask).backward(do.float())
    for got, ref in ((q.grad, qr.grad), (k.grad, kr.grad), (v.grad, vr.grad)):
        assert_agrees(got, ref, VS_FP32_TOL)


@pytest.mark.gpu
def test_dense_layout_equals_unmasked_kernels(cuda):
    q, k, v, do = _inputs(1, 512, 8, 8, 128, torch.bfloat16, seed=9)
    dense = sa.SparseSelfAttention(sa.DenseSparsityConfig(block=128))
    got, want = [], []
    for call, acc in ((dense, got), (lambda *x: flash_attention(*x, causal=True), want)):
        x = [t.clone().requires_grad_() for t in (q, k, v)]
        out = call(*x)
        out.backward(do)
        acc.extend([out.detach(), *(t.grad for t in x)])
    torch.cuda.synchronize()
    for g, w, kind in zip(got, want, ("fwd", "bwd", "bwd", "bwd")):
        print("bit_equal", torch.equal(g, w))
        assert_agrees(g, w, AGREE_TOL[kind][torch.bfloat16])


# ---------------------------------------------------------------------------
# K4, the paged decode attention, at chip_smoke.py's shapes
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("case", [c[0] for c in DECODE_CASES])
def test_decode_attention_matches_plain_version(cuda, case):
    spec = next(c for c in DECODE_CASES if c[0] == case)
    lengths = [17, 300, 2047, 1000, 0 if case == "len0" else 129, 64, 555, 1500]
    if case in ("full", "skew"):          # cases with lengths of their own
        lengths = decode_lengths(spec, 0)
    g = torch.Generator(device="cuda").manual_seed(11)
    q, k, v, mask, table = _decode_case(g, spec, lengths)
    with torch.inference_mode():
        before = decode_attention.launches
        out = decode_attention(q, k, v, mask, table)
        torch.cuda.synchronize()
        assert decode_attention.launches == before + 1
        ref = decode_attention_reference(q, k, v, mask, table)
        low = decode_low_precision(q, k, v, mask, table)
    reading = decode_compare(out, ref, low, spec[2] // spec[3], DECODE_TOL[spec[5]])
    print(json.dumps(reading))
    assert out.dtype == q.dtype and out.shape == q.shape
    assert reading["ok"] and reading["yardsticks_rejected"], reading


def _decode_inputs(case, lengths, seed=11):
    spec = next(c for c in DECODE_CASES if c[0] == case)
    g = torch.Generator(device="cuda").manual_seed(seed)
    return spec, _decode_case(g, spec, lengths)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["serve", "skew", "gqa", "fp32"])
def test_decode_attention_reruns_are_bit_identical(cuda, case):
    """The cluster ranks merge in a fixed order through distributed shared
    memory (no atomics): two launches give the same bits."""
    spec, (q, k, v, mask, table) = _decode_inputs(case, [17, 300, 2047, 1000, 129, 64,
                                                         555, 4095])
    with torch.inference_mode():
        first = decode_attention(q, k, v, mask, table)
        second = decode_attention(q, k, v, mask, table)
    assert torch.equal(first, second)


@pytest.mark.gpu
def test_decode_graph_replay_follows_lengths_and_tables(cuda):
    """A CUDA graph captured once (the grid depends on shapes only, the
    pools' tensor maps are encoded at capture) and replayed on static
    buffers whose lengths and page tables change gives the eager calls'
    outputs, bit for bit."""
    spec, (q, k, v, mask, table) = _decode_inputs("serve", [5] * 8)
    B, maxp = table.shape
    T = mask.shape[1]
    sq, smask, stable = q.clone(), mask.clone(), table.clone()
    with torch.inference_mode():
        decode_attention(sq, k, v, smask, stable)          # settle before capture
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = decode_attention(sq, k, v, smask, stable)
        g = torch.Generator(device="cuda").manual_seed(5)
        for lengths in ([0, 1, 127, 128, 129, 1000, 2047, 4095],
                        [4095, 1, 1, 1, 1, 1, 1, 1], [300] * 8):
            n = torch.tensor(lengths, device="cuda")
            smask.copy_((torch.arange(T, device="cuda")[None] <= n[:, None]).to(torch.int32))
            stable.copy_(torch.randperm(k.shape[0] - 1, generator=g, device="cuda")[
                :B * maxp].reshape(B, maxp).to(torch.int32) + 1)
            sq.copy_(torch.randn(q.shape, generator=g, device="cuda").to(q.dtype))
            graph.replay()
            eager = decode_attention(sq, k, v, smask, stable)
            torch.cuda.synchronize()
            assert torch.equal(out, eager), lengths


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("Hq,Hkv,hd", [(32, 32, 128), (32, 8, 128), (16, 2, 64)])
def test_decode_attention_honours_mask_holes(cuda, Hq, Hkv, hd, dtype):
    """Holes below the length (single keys, a whole 32-key tile, every
    other key) are not attended: K4 agrees with the plain version on the
    same mask, and the keys in the holes hold NaN when the kernel runs (not
    when the plain version does), which a kernel that read them into its
    sums would carry into the output.  A row with no live key is written as
    zeros."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(3)
    B, page, maxp = 4, 64, 16
    T, P = page * maxp, 1 + B * maxp
    q = torch.randn((B, Hq, hd), generator=g, device="cuda").to(dt)
    k, v = (torch.randn((P, page, Hkv, hd), generator=g, device="cuda").to(dt)
            for _ in range(2))
    table = (torch.randperm(P - 1, generator=g, device="cuda")[:B * maxp]
             .reshape(B, maxp).to(torch.int32) + 1)
    t = torch.arange(T, device="cuda")
    mask = (t[None] <= torch.tensor([900, 700, 1023, 0], device="cuda")[:, None])
    mask[0, 64:96] = False                               # a whole tile
    mask[0, [3, 100, 511]] = False
    mask[1, 1::2] = False                                # every other key
    mask[2] = torch.rand(T, generator=g, device="cuda") < 0.3
    mask[3] = False                                      # no live key
    imask = mask.to(torch.int32)
    with torch.inference_mode():
        ref = decode_attention_reference(q, k, v, imask, table)
        dead = (table.long()[:, t // page] * page + t % page)[~mask]
        for pool in (k, v):
            pool.view(-1, Hkv, hd)[dead] = float("nan")   # after the plain version
        out = decode_attention(q, k, v, imask, table)
        torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert not out[3].any()
    reading = agreement(out[:3, :, None], ref[:3, :, None], DECODE_TOL[dt], tile=1)
    print(json.dumps(reading))
    assert reading["ok"], reading


@pytest.mark.gpu
def test_decode_attention_empty_cache_writes_zeros(cuda):
    """T = 0: no row has a key, and every output row is written as zeros
    (not left as the allocator's leftovers: the block freed below holds
    NaN, and the caching allocator hands the output that block)."""
    q = torch.randn((2, 4, 128), device="cuda").to(torch.bfloat16)
    pool = torch.zeros((3, 16, 2, 128), device="cuda", dtype=torch.bfloat16)
    table = torch.ones((2, 1), device="cuda", dtype=torch.int32)
    mask = torch.zeros((2, 0), device="cuda", dtype=torch.int32)
    torch.full_like(q, float("nan"))          # freed at once: the next block of this size
    with torch.inference_mode():
        out = decode_attention(q, pool, pool, mask, table)
        torch.cuda.synchronize()
    assert out.shape == q.shape and not out.isnan().any() and not out.any()


def _hd64_engine(dtype):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import CausalLM

    model = CausalLM("tiny", hidden_size=256, intermediate_size=512, num_heads=4,
                     dtype=dtype)
    params = model.init_fn(torch.Generator(device="cuda").manual_seed(0),
                           device="cuda", dtype=dtype)
    return deepspeed_tpu_torch.init_inference(
        model, config={"dtype": str(dtype).replace("torch.", "")}, params=params)


@pytest.mark.gpu
def test_decode_graph_replay_matches_eager_decode(cuda):
    """The serving engine's decode step, captured once as a CUDA graph:
    a replay gives the eager forward's logits on the same inputs, and the
    served fp32 streams equal generate()."""
    import numpy as np
    from deepspeed_tpu_torch.inference import Request

    eng = _hd64_engine(torch.float32)
    sv = eng.serving(b_slots=3, page_size=16, max_model_len=128)
    ex = sv._exec
    assert ex.captures == 1 and ex.graph_k4_launches == eng.model.config.num_layers
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, input_ids=rng.integers(1, 250, n).astype(np.int32),
                    max_new_tokens=12) for i, n in enumerate((5, 40, 17, 70))]
    for r in reqs:
        sv.submit(r)
    for _ in range(3):
        sv.step()
    state = (sv._page_table.copy(), sv._lengths.copy(), sv._last_tok.copy(),
             sv._active.copy())
    with torch.no_grad():
        eager = ex._decode_forward(*(torch.from_numpy(x).to("cuda") for x in (
            state[0], state[1], state[2].astype(np.int64), state[3])))[:, -1].clone()
        for buf, x in zip((ex._g_pt, ex._g_len, ex._g_tok, ex._g_active), state):
            buf.copy_(torch.from_numpy(x.astype(np.int64) if x is state[2] else x))
        ex._graph.replay()
        replayed = ex._g_logits[:, -1].clone()
    live = torch.from_numpy(state[3]).to("cuda")
    torch.testing.assert_close(replayed[live], eager[live], rtol=0, atol=0)
    results = sv.run([])
    assert ex.captures == 1 and ex.replays > 0
    for res in results:
        req = reqs[res.rid]
        base = eng.generate(req.input_ids[None], max_new_tokens=12)
        np.testing.assert_array_equal(
            res.output_ids, base[0, len(req.input_ids):].cpu().numpy())
    assert sv.page_accounting()["balanced"]


@pytest.mark.gpu
def test_tp_decode_graph_at_world_one(cuda):
    """The tensor-parallel serving path on one card (NCCL world 1, a model
    axis of 1): the decode step is still one CUDA graph, now holding the
    model axis's all-reduces (two a layer and the embedding's) and the
    logits' all-gather; replays follow the changing lengths and page
    tables, and the served fp32 streams equal the unsharded engine's."""
    import socket

    import numpy as np
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.inference import Request
    from deepspeed_tpu_torch.parallel.mesh import initialize_serving_mesh

    base = _hd64_engine(torch.float32)
    rng = np.random.default_rng(1)
    reqs = [Request(rid=i, input_ids=rng.integers(1, 250, n).astype(np.int32),
                    max_new_tokens=m) for i, (n, m) in enumerate(
                        ((5, 12), (40, 3), (17, 20), (70, 7), (9, 16)))]
    ref = {r.rid: r.output_ids for r in
           base.serving(b_slots=3, page_size=16, max_model_len=128).run(list(reqs))}
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    comm.init_distributed(init_method=f"tcp://127.0.0.1:{port}", rank=0,
                          world_size=1, verbose=False)
    try:
        comm.configure({"enabled": True})
        eng = deepspeed_tpu_torch.init_inference(
            base.model, config={"dtype": "float32"}, params=base.params,
            mesh=initialize_serving_mesh(tp=1))
        sv = eng.serving(b_slots=3, page_size=16, max_model_len=128)
        ex = sv._exec
        L = eng.model.config.num_layers
        assert ex.captures == 1 and ex.graph_k4_launches == L
        assert ex.graph_collectives["all_reduce"]["model"] == 2 * L + 1
        assert ex.graph_collectives["all_gather"]["model"] == 1
        got = {r.rid: r.output_ids for r in sv.run(list(reqs))}
        assert ex.captures == 1 and ex.replays > 0
        for rid, ids in ref.items():
            np.testing.assert_array_equal(got[rid], ids)
        assert sv.page_accounting()["balanced"]
        h = sv.health()
        assert h["kv_pool_bytes_per_device"] == h["kv_pool_bytes_total"]
        sv.close()
    finally:
        comm.destroy_process_group()


# ---------------------------------------------------------------------------
# K4's int8 mode (kv_dtype="int8" pages), at chip_smoke.py's int8 cases
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("case", list(DECODE_INT8_CASES) + ["verify"])
def test_decode_attention_int8_matches_plain_version(cuda, case):
    """The int8 pages and their scale rows read in place, each element
    round(code * scale) in the compute dtype: within the case dtype's K4
    bounds of the plain version (gather, kv_dequantize, attend), and
    rejecting the yardsticks; a verify block's B*(k+1) rows too."""
    spec = next(c for c in DECODE_CASES if c[0] == ("serve" if case == "verify" else case))
    lengths = [17, 300, 2047, 1000, 129, 64, 555, 1500]
    g = torch.Generator(device="cuda").manual_seed(13)
    q, k, v, mask, table = _decode_case(g, spec, lengths)
    k8, v8, ks, vs = quantize_pools(k, v)
    if case == "verify":
        q, table, mask = verify_rows(g, q, table, mask, lengths)
    with torch.inference_mode():
        before = decode_attention.launches
        out = decode_attention(q, k8, v8, mask, table, k_scale=ks, v_scale=vs)
        torch.cuda.synchronize()
        assert decode_attention.launches == before + 1
        ref = decode_attention_reference(q, k8, v8, mask, table, k_scale=ks, v_scale=vs)
        kd = (k8.float() * ks[..., None, None]).to(q.dtype)
        vd = (v8.float() * vs[..., None, None]).to(q.dtype)
        assert torch.equal(ref, decode_attention_reference(q, kd, vd, mask, table))
        low = decode_low_precision(q, kd, vd, mask, table)
        again = decode_attention(q, k8, v8, mask, table, k_scale=ks, v_scale=vs)
    reading = decode_compare(out, ref, low, spec[2] // spec[3], DECODE_TOL[spec[5]])
    print(json.dumps(reading))
    assert out.dtype == q.dtype and out.shape == q.shape
    assert reading["ok"] and reading["yardsticks_rejected"], reading
    assert torch.equal(out, again)


@pytest.mark.gpu
def test_decode_attention_int8_refuses_mismatched_inputs(cuda):
    q = torch.zeros((1, 4, 128), device="cuda", dtype=torch.bfloat16)
    pool = torch.zeros((2, 8, 4, 128), device="cuda", dtype=torch.int8)
    scale = torch.ones((2, 8), device="cuda")
    mask = torch.ones((1, 8), device="cuda", dtype=torch.int32)
    table = torch.ones((1, 1), device="cuda", dtype=torch.int32)
    for bad in (lambda: decode_attention(q, pool, pool, mask, table),           # no scales
                lambda: decode_attention(q, pool, pool, mask, table, k_scale=scale),
                lambda: decode_attention(q, pool, pool, mask, table,
                                         k_scale=scale[:1], v_scale=scale),
                lambda: decode_attention(q, pool.to(torch.bfloat16), pool, mask, table,
                                         k_scale=scale, v_scale=scale),
                # a page of 6 rows: a tile's scale rows are not whole 16 bytes
                lambda: decode_attention(q, pool[:, :6].contiguous(), pool[:, :6].contiguous(),
                                         mask[:, :6], table, k_scale=scale[:, :6].contiguous(),
                                         v_scale=scale[:, :6].contiguous())):
        with pytest.raises((ValueError, TypeError, NotImplementedError)):
            bad()


# ---------------------------------------------------------------------------
# MoE and pipeline paths on the card (ROADMAP queue 1, item 9)
# ---------------------------------------------------------------------------

def _moe_engine(dtype, drop):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import CausalLM

    model = CausalLM("tiny-moe", hidden_size=256, intermediate_size=512, num_heads=4,
                     num_experts=8, moe_drop_tokens=drop, dtype=dtype)
    params = model.init_fn(torch.Generator(device="cuda").manual_seed(0),
                           device="cuda", dtype=dtype)
    return deepspeed_tpu_torch.init_inference(
        model, config={"dtype": str(dtype).replace("torch.", "")}, params=params)


@pytest.mark.gpu
@pytest.mark.parametrize("drop", [True, False])
def test_moe_decode_graph_serves_generate_tokens(cuda, drop):
    """An MoE model's decode tick captured once (the no-drop MoE in its
    static form, the capacity path's index dispatch: no host sync inside
    the capture), K4 once a layer in the graph, no new capture in steady
    state; served fp32 greedy streams equal ``generate``."""
    import numpy as np
    from deepspeed_tpu_torch.inference import Request

    eng = _moe_engine(torch.float32, drop)
    sv = eng.serving(b_slots=4, page_size=16, max_model_len=128)
    ex = sv._exec
    assert ex.captures == 1 and ex.graph_k4_launches == eng.model.config.num_layers
    rng = np.random.default_rng(1)
    reqs = [Request(rid=i, input_ids=rng.integers(1, 250, n).astype(np.int32),
                    max_new_tokens=10) for i, n in enumerate((5, 40, 17, 70, 33))]
    results = sv.run(reqs)
    assert ex.captures == 1 and ex.replays > 0
    for res in results:
        req = reqs[res.rid]
        base = eng.generate(req.input_ids[None], max_new_tokens=10)
        np.testing.assert_array_equal(
            res.output_ids, base[0, len(req.input_ids):].cpu().numpy())
    assert sv.page_accounting()["balanced"]
    sv.close()


@pytest.mark.gpu
@pytest.mark.parametrize("drop", [True, False])
def test_moe_training_step_runs_the_kernels(cuda, drop):
    """An MoE model at S=2048 trains through K1 (2 a layer under remat),
    K2 and K3 (one a layer each); its fp32 gradients agree with the plain
    attention branch's (the MoE layers are the same code on both)."""
    from deepspeed_tpu_torch.models import CausalLM
    from deepspeed_tpu_torch.utils.tree import tree_leaves, tree_map

    grads = {}
    for impl in ("auto", "xla"):
        model = CausalLM("tiny-moe", hidden_size=256, intermediate_size=512, num_heads=4,
                         max_seq_len=2048, remat=True, moe_drop_tokens=drop,
                         dtype=torch.float32, attn_impl=impl)
        params = tree_map(lambda x: x.requires_grad_(), model.init_fn(
            torch.Generator(device="cuda").manual_seed(0), device="cuda"))
        tokens = torch.randint(0, 256, (1, 2048), device="cuda",
                               generator=torch.Generator(device="cuda").manual_seed(1))
        for fn in (fa.flash_attention, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv):
            fn.launches = 0
        model.loss_fn(params, {"input_ids": tokens}).backward()
        counts = (fa.flash_attention.launches, fa.flash_attention_bwd_dq.launches,
                  fa.flash_attention_bwd_dkv.launches)
        L = model.config.num_layers
        assert counts == ((2 * L, L, L) if impl == "auto" else (0, 0, 0)), counts
        grads[impl] = [p.grad for p in tree_leaves(params)]
    for a, b in zip(grads["auto"], grads["xla"]):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pipeline_virtual_stages_match_unpipelined(cuda, schedule):
    """4 virtual stages of 1 layer and 4 microbatches at S=2048 (bf16, the
    kernels): the same loss and gradient norm as the un-pipelined engine
    at gas=4 on the same rows, K1-K3 launched as there."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import CausalLM

    cfg = {"train_micro_batch_size_per_gpu": 1, "gradient_accumulation_steps": 4,
           "optimizer": {"type": "adamw", "params": {"lr": 1e-4}},
           "bf16": {"enabled": True}, "steps_per_print": 10 ** 9}
    tokens = torch.randint(0, 256, (4, 2048), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))
    out = {}
    for label, kw in (("plain", {}), ("pipe", dict(pipeline_stages=4, pipeline_microbatches=4,
                                                   pipeline_schedule=schedule))):
        model = CausalLM("tiny", hidden_size=256, intermediate_size=512, num_heads=4,
                         num_layers=4, max_seq_len=2048, remat=True, **kw)
        engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg)
        for fn in (fa.flash_attention, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv):
            fn.launches = 0
        losses = [float(engine.train_batch(batch={"input_ids": tokens})) for _ in range(2)]
        out[label] = (losses, engine.get_global_grad_norm(),
                      (fa.flash_attention.launches, fa.flash_attention_bwd_dq.launches,
                       fa.flash_attention_bwd_dkv.launches))
    assert out["pipe"][2] == out["plain"][2] == (2 * 2 * 4 * 4, 2 * 4 * 4, 2 * 4 * 4)
    torch.testing.assert_close(torch.tensor(out["pipe"][0]), torch.tensor(out["plain"][0]),
                               rtol=1e-5, atol=0)
    torch.testing.assert_close(out["pipe"][1], out["plain"][1], rtol=1e-4, atol=0)


@pytest.mark.gpu
def test_profiled_step_counts_the_kernels_per_launch(cuda):
    """The flops profiler at a bf16 train step through K1-K3 (``remat``: K1
    twice a layer): the kernels' products over the causal pairs, counted
    by hand, added per launch, every matmul 2*M*K*N forward and twice that
    backward, and the recompute of the layers but w_down, exactly."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import CausalLM

    S = 2048
    model = CausalLM("tiny", dtype=torch.bfloat16, remat=True, max_seq_len=S,
                     hidden_size=256, num_heads=2, intermediate_size=512)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config={
        "train_batch_size": 1, "bf16": {"enabled": True},
        "flops_profiler": {"enabled": True, "profile_step": 1}})
    engine.train_batch(batch={"input_ids": torch.randint(0, 256, (1, S), device="cuda")})
    cfg = model.config
    L, d, f = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    layers = 2 * S * L * (4 * d * d + 3 * d * f)
    head = 2 * S * d * cfg.vocab_size
    # K1 twice a layer (2 products a pair), K2 (3) and K3 (4) once
    kern = (2 * 2 + 3 + 4) * 2.0 * cfg.num_heads * (S * (S + 1) // 2) * cfg.dims_per_head * L
    got = engine.flops_profiler.as_dict()
    assert got["kernel_flops"] == kern
    assert got["flops"] == 3 * (layers + head) + layers - 2 * S * L * f * d + kern


@pytest.mark.gpu
def test_compile_counter_counts_the_decode_capture(cuda):
    """The paged server captures its decode step once at build: the
    compile counter moves by the captures its program inventory counts."""
    import numpy as np

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference import Request
    from deepspeed_tpu_torch.models import CausalLM
    from deepspeed_tpu_torch.utils.compile_counter import compile_counter

    count = compile_counter()
    model = CausalLM("tiny", dtype=torch.bfloat16, hidden_size=256, num_heads=2)   # hd 128
    eng = deepspeed_tpu_torch.init_inference(
        model, config={"dtype": "bf16"},
        params=model.init_fn(torch.Generator(device="cuda").manual_seed(0), dtype=torch.bfloat16))
    before = count()
    sv = eng.serving(b_slots=2, page_size=8, max_model_len=64)
    built = count() - before
    sv.run([Request(0, input_ids=np.arange(1, 9), max_new_tokens=6)])
    assert built == sv.program_inventory()["captures"] == 1
    assert count() - before == 1      # the run replays, it captures nothing
