"""The port's block-sparse attention against the JAX package's.

Layouts: every sparsity config's ``make_layout`` equals the JAX package's
bit for bit (random blocks included).  ``SparseSelfAttention`` and the
masked ``flash_attention``: on the CPU the port runs its plain versions;
the JAX package runs its Pallas kernels in interpret mode, as
tests/unit/test_sparse_attention.py does.  Inputs are drawn with numpy and
fed to both: forward at fp32 atol 2e-5, gradients against ``jax.grad`` at
5e-4 (the flash tests' tolerances: only summation order differs).  The
kernels' live-tile tables are checked by decoding them the way the CUDA
kernels do; the kernels themselves run on the card
(tests/test_torch_kernels_gpu.py, chip_smoke.py)."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.ops import sparse_attention as jax_sa
from deepspeed_tpu.ops.pallas import flash_attention as jax_fa
from deepspeed_tpu_torch.ops import sparse_attention as port_sa
from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
from deepspeed_tpu_torch.ops.kernels.flash_attention import (
    attended, flash_attention, flash_attention_bwd_dkv_reference,
    flash_attention_bwd_dq_reference, live_tile_tables)

ATOL = 2e-5
GRAD_ATOL = 5e-4
HD = 32

# (config class, keyword arguments at a given block)
PATTERNS = [
    ("DenseSparsityConfig", {}),
    ("FixedSparsityConfig", {"num_local_blocks": 2, "num_global_blocks": 1}),
    ("BigBirdSparsityConfig", {"num_sliding_window_blocks": 1,
                               "num_random_blocks": 1, "num_global_blocks": 1}),
    ("BSLongformerSparsityConfig", {"num_sliding_window_blocks": 3,
                                    "global_block_indices": (0,)}),
    ("LocalSlidingWindowSparsityConfig", {"num_sliding_window_blocks": 3}),
    ("VariableSparsityConfig", {"local_window_blocks": (1, 2),
                                "global_block_indices": (0,)}),
]


def _configs(i, block, attention):
    name, kw = PATTERNS[i]
    kw = dict(kw, block=block, attention=attention)
    return getattr(jax_sa, name)(**kw), getattr(port_sa, name)(**kw)


def _qkv(B, S, Hq, Hkv, seed):
    rs = np.random.RandomState(seed)
    return tuple(rs.standard_normal((B, S, H, HD)).astype(np.float32)
                 for H in (Hq, Hkv, Hkv, Hq))


def _torch(*xs, grad=False):
    return tuple(torch.from_numpy(x).requires_grad_(grad) for x in xs)


# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------

LAYOUT_CASES = [
    ("DenseSparsityConfig", {}),
    ("FixedSparsityConfig", {"num_local_blocks": 4, "num_global_blocks": 1}),
    ("FixedSparsityConfig", {"num_local_blocks": 3, "num_global_blocks": 2}),
    ("VariableSparsityConfig", {"num_random_blocks": 2,
                                "local_window_blocks": (2, 4),
                                "global_block_indices": (0, 5)}),
    ("BigBirdSparsityConfig", {}),
    ("BigBirdSparsityConfig", {"num_random_blocks": 3,
                               "num_sliding_window_blocks": 5,
                               "num_global_blocks": 2}),
    ("BSLongformerSparsityConfig", {"num_sliding_window_blocks": 5,
                                    "global_block_indices": (0, 3)}),
    ("LocalSlidingWindowSparsityConfig", {"num_sliding_window_blocks": 7}),
]


@pytest.mark.parametrize("attention", ["unidirectional", "bidirectional"])
@pytest.mark.parametrize("case", range(len(LAYOUT_CASES)))
def test_layouts_equal_jax_bit_for_bit(case, attention):
    name, kw = LAYOUT_CASES[case]
    for block, S in ((16, 256), (64, 1024), (128, 4096)):
        j = getattr(jax_sa, name)(block=block, attention=attention, **kw)
        p = getattr(port_sa, name)(block=block, attention=attention, **kw)
        want, got = j.make_layout(S), p.make_layout(S)
        assert got.dtype == want.dtype == bool
        np.testing.assert_array_equal(got, want)
        a, b = jax_sa.SparseSelfAttention(j, S), port_sa.SparseSelfAttention(p, S)
        assert a.density(S) == b.density(S)


# ---------------------------------------------------------------------------
# SparseSelfAttention forward and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("attention", ["unidirectional", "bidirectional"])
@pytest.mark.parametrize("i", range(len(PATTERNS)), ids=[p[0] for p in PATTERNS])
def test_sparse_self_attention_matches_jax(i, attention):
    block = (32, 64, 128)[i % 3]
    Hq, Hkv = ((4, 4), (8, 2))[(i + (attention == "bidirectional")) % 2]
    jcfg, pcfg = _configs(i, block, attention)
    q, k, v, _ = _qkv(1, 256, Hq, Hkv, seed=i)
    ref = jax_sa.SparseSelfAttention(jcfg)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True)
    before = flash_attention.launches
    out = port_sa.SparseSelfAttention(pcfg)(*_torch(q, k, v))
    assert flash_attention.launches == before          # CPU: the plain version
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


GRAD_CASES = [  # (pattern, attention, block, Hq, Hkv)
    (3, "unidirectional", 64, 8, 2),
    (2, "bidirectional", 32, 4, 4),
    (1, "unidirectional", 128, 4, 4),
    (5, "bidirectional", 64, 8, 2),
    (4, "unidirectional", 32, 8, 2),
]


@pytest.mark.parametrize("case", GRAD_CASES, ids=lambda c: f"{PATTERNS[c[0]][0]}-{c[1]}-b{c[2]}-{c[3]}x{c[4]}")
def test_sparse_self_attention_grads_match_jax(case):
    i, attention, block, Hq, Hkv = case
    jcfg, pcfg = _configs(i, block, attention)
    q, k, v, do = _qkv(1, 256, Hq, Hkv, seed=20 + i)
    jsa = jax_sa.SparseSelfAttention(jcfg)
    ref = jax.grad(lambda q, k, v: jnp.sum(jsa(q, k, v, interpret=True) * do),
                   argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = _torch(q, k, v, grad=True)
    (port_sa.SparseSelfAttention(pcfg)(tq, tk, tv) * torch.from_numpy(do)).sum().backward()
    for g, r, name in zip((tq.grad, tk.grad, tv.grad), ref, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=GRAD_ATOL,
                                   err_msg=f"d{name}")


def test_custom_scale_and_raw_mask_with_unequal_blocks_match_jax():
    """A raw block mask through ``flash_attention`` with block_q != block_k
    (mask blocks need not be square) and a custom scale."""
    q, k, v, do = _qkv(1, 256, 8, 2, seed=7)
    mask = np.random.default_rng(3).random((4, 8)) < 0.5
    mask[:, 0] = True
    kw = dict(causal=True, sm_scale=0.3, block_q=64, block_k=32, block_mask=mask)
    ref = jax_fa.flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                 interpret=True, **kw)
    out = flash_attention(*_torch(q, k, v), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    ref_g = jax.grad(lambda q, k, v: jnp.sum(jax_fa.flash_attention(
        q, k, v, interpret=True, **kw) * do), argnums=(0, 1, 2))(
            *(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = _torch(q, k, v, grad=True)
    (flash_attention(tq, tk, tv, **kw) * torch.from_numpy(do)).sum().backward()
    for g, r in zip((tq.grad, tk.grad, tv.grad), ref_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=GRAD_ATOL)


# ---------------------------------------------------------------------------
# Dead rows, dense layouts
# ---------------------------------------------------------------------------

def _dead_mask(causal):
    """4x4 blocks of 64 at S=256: block row 1 dead (no live key), key block
    2 seen by no query."""
    mask = np.tril(np.ones((4, 4), bool)) if causal else np.ones((4, 4), bool)
    mask[1] = False
    mask[:, 2] = False
    return mask


@pytest.mark.parametrize("causal", [True, False])
def test_dead_rows_match_the_jax_kernels_exactly(causal):
    """Rows with no live key: out 0, lse NEG_INF, dq 0; keys no live query
    sees: dk = dv = 0.  Against the Pallas ``_fwd``/``_bwd`` (interpreted),
    which never run a dead block."""
    mask = _dead_mask(causal)
    q, k, v, do = _qkv(2, 256, 4, 2, seed=31)
    scale = 1.0 / np.sqrt(HD)
    qt, kt, vt, dot = (jnp.swapaxes(jnp.asarray(x), 1, 2) for x in (q, k, v, do))
    bm = tuple(tuple(int(x) for x in row) for row in mask)
    jout, jlse = jax_fa._fwd(qt, kt, vt, scale, causal, 64, 64, True, bm)
    jdq, jdk, jdv = jax_fa._bwd(scale, causal, 64, 64, True,
                                (qt, kt, vt, jout, jlse), dot, bm)
    out, lse = fa._forward(*_torch(q, k, v), causal, scale,
                           fa._as_block_mask(mask, 256))
    np.testing.assert_allclose(out.numpy(), np.asarray(jnp.swapaxes(jout, 1, 2)),
                               atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, :, 0], atol=ATOL)
    assert (out[:, 64:128] == 0).all() and (lse[:, :, 64:128] == -1e30).all()
    delta = (do * out.numpy()).sum(-1).transpose(0, 2, 1).copy()
    args = (*_torch(q, k, v, do), lse, torch.from_numpy(delta), causal, scale, mask)
    dq = flash_attention_bwd_dq_reference(*args)
    dk, dv = flash_attention_bwd_dkv_reference(*args)
    for got, ref in ((dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(jnp.swapaxes(ref, 1, 2)),
                                   atol=GRAD_ATOL)
    assert (dq[:, 64:128] == 0).all()
    assert (dk[:, 128:192] == 0).all() and (dv[:, 128:192] == 0).all()
    # through autograd: the same zeros
    tq, tk, tv = _torch(q, k, v, grad=True)
    (flash_attention(tq, tk, tv, causal=causal, block_q=64, block_k=64,
                     block_mask=mask) * torch.from_numpy(do)).sum().backward()
    assert (tq.grad[:, 64:128] == 0).all() and (tk.grad[:, 128:192] == 0).all()


def test_dense_layout_equals_unmasked_causal_flash():
    q, k, v, do = _qkv(2, 256, 8, 2, seed=41)
    sa = port_sa.SparseSelfAttention(port_sa.DenseSparsityConfig(block=64))
    tq, tk, tv = _torch(q, k, v, grad=True)
    (sa(tq, tk, tv) * torch.from_numpy(do)).sum().backward()
    uq, uk, uv = _torch(q, k, v, grad=True)
    (flash_attention(uq, uk, uv, causal=True) * torch.from_numpy(do)).sum().backward()
    torch.testing.assert_close(sa(*_torch(q, k, v)), flash_attention(*_torch(q, k, v)),
                               rtol=0, atol=ATOL)
    for a, b in ((tq.grad, uq.grad), (tk.grad, uk.grad), (tv.grad, uv.grad)):
        torch.testing.assert_close(a, b, rtol=0, atol=GRAD_ATOL)


# ---------------------------------------------------------------------------
# Refusals, with the JAX package's exception types
# ---------------------------------------------------------------------------

def test_refusals_match_jax():
    q, k, v, _ = _qkv(1, 256, 2, 2, seed=0)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    tq, tk, tv = _torch(q, k, v)
    wrong = np.ones((2, 2), bool)
    for call in (lambda: jax_fa.flash_attention(jq, jk, jv, block_q=64, block_k=64,
                                                interpret=True, block_mask=wrong),
                 lambda: flash_attention(tq, tk, tv, block_q=64, block_k=64,
                                         block_mask=wrong)):
        with pytest.raises(ValueError, match="block grid"):
            call()
    good = np.ones((4, 4), bool)
    for call in (lambda: jax_fa.flash_attention(jq, jk, jv, block_q=64, block_k=64,
                                                interpret=True, block_mask=good,
                                                return_lse=True),
                 lambda: flash_attention(tq, tk, tv, block_q=64, block_k=64,
                                         block_mask=good, return_lse=True)):
        with pytest.raises(NotImplementedError, match="return_lse"):
            call()
    for pkg in (jax_sa, port_sa):
        sa = pkg.SparseSelfAttention(pkg.FixedSparsityConfig(block=64), 128)
        with pytest.raises(ValueError, match="max_seq_length"):
            sa.layout(256)
        with pytest.raises(ValueError, match="multiple"):
            pkg.FixedSparsityConfig(block=100).make_layout(256)
        with pytest.raises(ValueError, match="attention"):
            pkg.DenseSparsityConfig(attention="sideways")
    with pytest.raises(ValueError, match="multiple"):
        port_sa.SparseSelfAttention(port_sa.FixedSparsityConfig(block=96))(tq, tk, tv)


# ---------------------------------------------------------------------------
# The kernels' live-tile tables, decoded as the CUDA kernels decode them
# ---------------------------------------------------------------------------

def _decode(table, name, S, causal):
    """The [S, S] of pairs a kernel attends, from its table, with the index
    arithmetic of flash_attention_{fwd,bwd}.cu: per CTA tile its list, per
    warp (or row) its word and shift, per element its bit and the causal
    diagonal."""
    off, idx, bits = table.off.tolist(), table.idx.tolist(), table.bits.tolist()
    got = np.zeros((S, S), bool)
    rows, cols = fa._TILES[name]
    for t in range(len(off) - 1):
        for e in range(off[t], off[t + 1]):
            u = [w & 0xFFFFFFFF for w in bits[e]]
            r0, c0 = t * rows, idx[e] * cols
            for a in range(rows):
                for c in range(cols):
                    if name == "fwd":     # K1 (bf16/fp16): one word per consumer warp
                        warp, r = a // 16, (a // 8) % 2
                        on = (u[warp] >> (r * 16 + c // 8)) & 1
                    elif name in ("q", "kv"):   # K2, K3: 16 bits per consumer warp
                        warp, r = a // 16, (a // 8) % 2
                        live = (u[warp >> 1] >> ((warp & 1) * 16)) & 0xFFFF
                        on = (live >> (r * 8 + c // 8)) & 1
                    else:                 # fp32 K1/K2 ("f32"), K3 ("f32kv"): per row
                        live = (u[a >> 5] >> (((a >> 3) & 3) * 8)) & 0xFF
                        on = (live >> (c // 8)) & 1
                    # K3's tables run along the keys: rows are keys, cols queries
                    qi, ki = ((c0 + c, r0 + a) if name in ("kv", "f32kv")
                              else (r0 + a, c0 + c))
                    if on and (not causal or qi >= ki):
                        got[qi, ki] = True
    return got


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block_q,block_k", [(64, 64), (16, 32), (256, 128), (8, 8)])
def test_live_tile_tables_cover_exactly_the_attended_pairs(block_q, block_k, causal):
    S = 256
    rng = np.random.default_rng(block_q + block_k)
    mask = rng.random((S // block_q, S // block_k)) < 0.4
    mask[S // block_q // 2] = False                     # a dead block row
    want = attended(S, causal, mask).numpy()
    tables = live_tile_tables(mask, S, causal, "cpu")
    for name, table in tables.items():
        np.testing.assert_array_equal(_decode(table, name, S, causal), want,
                                      err_msg=name)
        n_tiles = len(table.off) - 1
        counts = np.diff(table.off.numpy())
        assert sorted(table.order.tolist()) == list(range(n_tiles))
        assert (np.diff(counts[table.order.numpy()]) <= 0).all()   # longest first
        for t in range(n_tiles):
            lst = table.idx[table.off[t]:table.off[t + 1]].tolist()
            assert lst == sorted(set(lst))
    assert live_tile_tables(mask, S, causal, "cpu") is tables    # cached


def _cu_constants(source):
    """The ``constexpr int NAME = value;`` lines of a kernel source."""
    text = (Path(fa.__file__).resolve().parent.parent / "csrc" / source).read_text()
    return {m[1]: int(m[2]) for m in
            re.finditer(r"^constexpr int (\w+) = (\d+);", text, re.MULTILINE)}


def test_table_tiles_match_the_kernels_tiles():
    """The wrapper's table tiles are the CUDA kernels' own loop tiles: a
    mismatch would show only on the card, as wrong or skipped tiles."""
    fwd = _cu_constants("flash_attention_fwd.cu")
    bwd = _cu_constants("flash_attention_bwd.cu")
    assert fa._TILES["fwd"] == (fwd["BLOCK_M"], fwd["BLOCK_N"])
    assert fa._TILES["f32"] == (fwd["F32_BLOCK"], fwd["F32_BLOCK"])
    assert fa._TILES["q"] == (bwd["DQ_BLOCK_M"], bwd["DQ_BLOCK_N"])
    assert fa._TILES["kv"] == (bwd["DKV_BLOCK_N"], bwd["DKV_BLOCK_M"])
    # the fp32 backward kernels walk 64 x 64 tiles: K2's the forward's
    # "f32" table, K3's its transposed "f32kv"
    assert fa._TILES["f32"] == (bwd["F32_BLOCK"], bwd["F32_BLOCK"])
    assert fa._TILES["f32kv"] == (bwd["F32_BLOCK"], bwd["F32_BLOCK"])
    assert set(fa._TILES) == {"fwd", "q", "f32", "kv", "f32kv"}
    # K1 reads one 32-bit word of an entry per consumer warp (the threads
    # past the producer warpgroup), each covering 16 rows of the tile
    rows, cols = fa._TILES["fwd"]
    words = rows // 8 * (cols // 8) // 32
    assert words == (fwd["NUM_THREADS"] - 128) // 32 == rows // 16
    tables = live_tile_tables(np.ones((2, 2), bool), 256, True, "cpu")
    assert tables["fwd"].bits.shape[1] == words
    # K2 and K3 read 16 bits of an entry per consumer warp: TILE_WORDS
    # words, each covering two warps' 16 rows
    for name, (rows, cols) in (("q", fa._TILES["q"]), ("kv", fa._TILES["kv"])):
        assert rows // 16 == (bwd["NUM_THREADS"] - 128) // 32
        assert rows // 8 * (cols // 8) // 32 == bwd["TILE_WORDS"]
        assert tables[name].bits.shape[1] == bwd["TILE_WORDS"]


def test_tables_refuse_blocks_the_kernels_cannot_mask():
    with pytest.raises(NotImplementedError, match="multiples of 8"):
        live_tile_tables(np.ones((32, 32), bool), 384, False, "cpu")   # 12-row blocks
