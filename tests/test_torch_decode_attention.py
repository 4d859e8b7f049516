"""K4's plain version against the JAX package, on the CPU.

``decode_attention_reference`` (and the ``decode_attention`` wrapper, which
runs it for CPU tensors) is held to the retired Pallas kernel
``tools/retired_decode_attention.py`` in interpret mode, and to the paged
einsum ``_attention_paged`` at S=1 over shuffled page tables.  The retired
module's ``from .common import pick_block`` needs a package, so it is loaded
under ``deepspeed_tpu.ops.pallas`` (the file itself stays as it is).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import deepspeed_tpu.ops.pallas.common  # noqa: F401  (parent of the K4 module)
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu_torch.models import CausalLM
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.ops.kernels import decode_attention as da

ROOT = Path(__file__).resolve().parent.parent
ATOL = 2e-5


def _retired_k4():
    spec = importlib.util.spec_from_file_location(
        "deepspeed_tpu.ops.pallas._retired_k4",
        ROOT / "tools" / "retired_decode_attention.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def k4():
    return _retired_k4()


def _ragged_mask(rs, B, T):
    """Random attendable sets plus a short prefix row: every row attends
    at least one key."""
    mask = rs.rand(B, T) < 0.6
    mask[0, :] = False
    mask[0, :37] = True
    mask[:, 0] = True
    return mask


@pytest.mark.parametrize("T", [256, 384])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("Hq,Hkv", [(8, 2), (4, 4)])
def test_reference_matches_jax_k4_interpret(k4, Hq, Hkv, hd, T):
    rs = np.random.RandomState(hd + T + Hkv)
    B = 2
    q = rs.standard_normal((B, Hq, hd)).astype(np.float32)
    k = rs.standard_normal((B, T, Hkv, hd)).astype(np.float32)
    v = rs.standard_normal((B, T, Hkv, hd)).astype(np.float32)
    mask = _ragged_mask(rs, B, T)
    ref = np.asarray(k4.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(mask), interpret=True, block_t=128))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tm = torch.from_numpy(mask)
    out = da.decode_attention_reference(tq, tk, tv, tm)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)
    # the wrapper runs the plain version for CPU tensors, bool or int mask
    wrapped = da.decode_attention(tq, tk, tv, tm.to(torch.int32))
    np.testing.assert_allclose(wrapped.numpy(), ref, atol=ATOL, rtol=0)


def _paged_case(rs, B, Hq, Hkv, hd, page, maxp, lengths):
    P = 1 + B * maxp
    pool_k = rs.standard_normal((P, page, Hkv, hd)).astype(np.float32)
    pool_v = rs.standard_normal((P, page, Hkv, hd)).astype(np.float32)
    perm = rs.permutation(np.arange(1, P))           # shuffled physical pages
    table = perm[:B * maxp].reshape(B, maxp).astype(np.int32)
    for b, n in enumerate(lengths):                  # unallocated -> trash page
        table[b, -(-(n + 1) // page):] = 0
    q = rs.standard_normal((B, Hq, hd)).astype(np.float32)
    return q, pool_k, pool_v, table


@pytest.mark.parametrize("page", [8, 128])
@pytest.mark.parametrize("Hq,Hkv", [(8, 2), (4, 4)])
def test_reference_matches_jax_paged_einsum(Hq, Hkv, page):
    """S=1 against the JAX package's ``_attention_paged`` over the gathered
    pages, with its causal mask ``t <= q_pos``."""
    rs = np.random.RandomState(page + Hq)
    B, hd, maxp = 3, 64, 256 // page
    lengths = [0, 37, 255]
    q, pk, pv, table = _paged_case(rs, B, Hq, Hkv, hd, page, maxp, lengths)
    T = maxp * page
    cfg = jtf.get_config("tiny", num_heads=Hq, num_kv_heads=Hkv, head_dim=hd)
    rows = (table[:, :, None] * page + np.arange(page)[None, None]).reshape(B, T)
    P = pk.shape[0]
    ck = pk.reshape(P * page, Hkv, hd)[rows]
    cv = pv.reshape(P * page, Hkv, hd)[rows]
    q_pos = np.asarray(lengths, np.int32)[:, None]
    ref = np.asarray(jtf._attention_paged(cfg, jnp.asarray(q[:, None]), jnp.asarray(ck),
                                          jnp.asarray(cv), jnp.asarray(q_pos)))[:, 0]
    mask = torch.arange(T)[None, :] <= torch.from_numpy(q_pos)
    out = da.decode_attention(torch.from_numpy(q), torch.from_numpy(pk),
                              torch.from_numpy(pv), mask, torch.from_numpy(table))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


def test_identity_table_and_shared_pages_are_one_call():
    """A contiguous cache is the paged call with the identity table; two
    rows mapping one physical page read the same keys."""
    rs = np.random.RandomState(5)
    B, T, Hkv, hd, page = 2, 64, 2, 64, 16
    q = torch.from_numpy(rs.standard_normal((B, 4, hd)).astype(np.float32))
    k = torch.from_numpy(rs.standard_normal((B, T, Hkv, hd)).astype(np.float32))
    v = torch.from_numpy(rs.standard_normal((B, T, Hkv, hd)).astype(np.float32))
    mask = torch.from_numpy(_ragged_mask(rs, B, T))
    contiguous = da.decode_attention(q, k, v, mask)
    pools = [x.reshape(B * T // page, page, Hkv, hd) for x in (k, v)]
    table = torch.arange(B * T // page, dtype=torch.int32).reshape(B, T // page)
    paged = da.decode_attention(q, *pools, mask, table)
    torch.testing.assert_close(paged, contiguous, rtol=0, atol=0)
    # row 1 maps row 0's first page: equal to a cache holding those rows
    shared = table.clone()
    shared[1, 0] = table[0, 0]
    k2, v2 = k.clone(), v.clone()
    k2[1, :page], v2[1, :page] = k[0, :page], v[0, :page]
    torch.testing.assert_close(da.decode_attention(q, *pools, mask, shared),
                               da.decode_attention(q, k2, v2, mask), rtol=0, atol=0)


def test_wrapper_checks_shapes():
    q = torch.zeros((2, 4, 64))
    pool = torch.zeros((5, 8, 2, 64))
    table = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="maxp"):
        da.decode_attention(q, pool, pool, torch.ones((2, 17), dtype=torch.bool), table)
    with pytest.raises(ValueError, match="page_table"):
        da.decode_attention(q, pool, pool, torch.ones((2, 8), dtype=torch.bool),
                            table[:1])
    with pytest.raises(ValueError, match="does not fit"):
        da.decode_attention(torch.zeros((2, 3, 64)), pool, pool,
                            torch.ones((2, 8), dtype=torch.bool), table)


@pytest.mark.parametrize("name,overrides,launches_k4", [
    ("tiny", {}, True),
    ("tiny-gqa", {}, True),
    ("tiny", {"position": "alibi", "norm": "layernorm", "activation": "gelu"}, False),
])
def test_decode_dispatch_by_config(monkeypatch, name, overrides, launches_k4):
    """Decode (S=1) of a non-alibi config goes through the K4 wrapper;
    alibi takes the einsum over gathered pages (dispatch by config, as the
    JAX ``_attention`` sends alibi to XLA), and so does prefill."""
    calls = []
    real = ttf.decode_attention

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(ttf, "decode_attention", spy)
    model = CausalLM(name, dtype=torch.float32, **overrides)
    params = model.init_fn(torch.Generator().manual_seed(0), device="cpu")
    cache = model.init_paged_cache(9, 8, device="cpu")
    table = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32)
    toks = torch.tensor([[3, 4, 5, 6, 7, 8, 0, 0]] * 2)
    seq = torch.arange(8)[None] < torch.tensor([[6], [4]])
    model.apply_paged(params, toks, cache, table, torch.zeros(2, dtype=torch.int32), seq)
    assert calls == []                                  # prefill: einsum
    model.apply_paged(params, toks[:, :1], cache, table,
                      torch.tensor([6, 4], dtype=torch.int32),
                      torch.ones((2, 1), dtype=torch.bool))
    L, Hq = model.config.num_layers, model.config.num_heads
    assert calls == ([(2, Hq, model.config.dims_per_head)] * L if launches_k4 else [])


# ---------------------------------------------------------------------------
# The kernel's split over a thread-block cluster: tiles of `rows` keys of a
# page, tile j to rank j % nsplit, per-rank online softmax merged in rank
# order (decode_attention_split_reference)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nsplit", [1, 2, 8])
@pytest.mark.parametrize("hd,page", [(64, 48), (128, 40), (128, None)])
def test_split_reference_matches_jax_k4_interpret(k4, nsplit, hd, page):
    """The split arithmetic against the retired Pallas K4 in interpret mode
    (on the same keys gathered contiguous), paged with short tiles (fp32
    tiles hold 32 rows at hd 64, 16 at hd 128: pages of 48 and 40 end in a
    short one, and T = 384 ends inside a page of 40) or contiguous (page
    None: the identity table)."""
    rs = np.random.RandomState(hd + nsplit + (page or 0))
    B, Hq, Hkv, T = 3, 8, 2, 384
    mask = _ragged_mask(rs, B, T)
    mask[2, :] = False
    mask[2, :201] = True                            # a prefix, as the paged path's
    q = rs.standard_normal((B, Hq, hd)).astype(np.float32)
    if page is None:
        k = rs.standard_normal((B, T, Hkv, hd)).astype(np.float32)
        v = rs.standard_normal((B, T, Hkv, hd)).astype(np.float32)
        ck, cv, table = k, v, None
    else:
        maxp = -(-T // page)
        _, k, v, table = _paged_case(rs, B, Hq, Hkv, hd, page, maxp, [T - 1] * B)
        rows = (table[:, :, None] * page + np.arange(page)[None, None]).reshape(B, -1)[:, :T]
        ck = k.reshape(-1, Hkv, hd)[rows]
        cv = v.reshape(-1, Hkv, hd)[rows]
    ref = np.asarray(k4.flash_decode(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                                     jnp.asarray(mask), interpret=True, block_t=128))
    out = da.decode_attention_split_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(mask), None if table is None else torch.from_numpy(table),
        nsplit=nsplit)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


def test_split_reference_empty_ranks_have_zero_weight(k4):
    """A row whose only live key is key 0 (the ``len0`` case): ranks 1..7
    hold no live key and keep (NEG_INF, 0, 0), the merge gives them zero
    weight, and the row is exactly V's key 0; a row with no live key is
    zeros.  The other rows still match the Pallas K4."""
    rs = np.random.RandomState(3)
    B, Hq, Hkv, hd, page, maxp = 3, 4, 2, 64, 16, 16
    T = page * maxp
    q, k, v, table = _paged_case(rs, B, Hq, Hkv, hd, page, maxp, [0, 150, T - 1])
    mask = np.arange(T)[None, :] <= np.array([[0], [150], [T - 1]])
    tq, tk, tv, tt = (torch.from_numpy(x) for x in (q, k, v, table))
    tm = torch.from_numpy(mask)
    nsplit, _ = da.split_plan(T, page, hd, torch.float32)
    assert nsplit == 8
    states = da._split_states(tq, tk, tv, tm, tt, nsplit, hd ** -0.5)
    for m, l, acc in states[1:]:
        assert bool((m[0] == da.NEG_INF).all()) and not l[0].any() and not acc[0].any()
    out = da.decode_attention_split_reference(tq, tk, tv, tm, tt)
    v0 = tv[table[0, 0], 0]                                    # [Hkv, hd]
    torch.testing.assert_close(out[0], v0.repeat_interleave(Hq // Hkv, 0), rtol=0, atol=0)
    rows = (table[:, :, None] * page + np.arange(page)[None, None]).reshape(B, T)
    ck, cv = (x.reshape(-1, Hkv, hd)[rows] for x in (k, v))
    ref = np.asarray(k4.flash_decode(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                                     jnp.asarray(mask), interpret=True, block_t=128))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)
    none = tm.clone()
    none[1] = False
    dead = da.decode_attention_split_reference(tq, tk, tv, none, tt)
    assert not dead[1].any()


@pytest.mark.parametrize("T,page,rows,nsplit", [
    (1000, 128, 32, 8),      # T not a multiple of nsplit * rows (256)
    (1000, 100, 32, 8),      # pages not a multiple of the tile: short tiles
    (4095, 16, 16, 8),
    (37, 4096, 64, 1),       # a contiguous cache shorter than one tile
    (300, 48, 16, 4),
])
def test_key_tiles_cover_every_key_once(T, page, rows, nsplit):
    """The tiles partition [0, T): every key in exactly one tile of at most
    ``rows`` keys inside one page, tiles in key order, and the ranks'
    tiles together are every tile once; the tile count is the kernel's
    ``(T // page) * ceil(page / rows) + ceil((T % page) / rows)``."""
    tiles = da.key_tiles(T, page, rows)
    assert tiles.shape == (T,) and bool((tiles[1:] >= tiles[:-1]).all())
    ntiles = int(tiles[-1]) + 1
    tpp = -(-page // rows)
    assert ntiles == (T // page) * tpp + -(-(T % page) // rows)
    t = torch.arange(T)
    for j in torch.unique(tiles).tolist():
        keys = t[tiles == j]
        assert 0 < len(keys) <= rows and len(torch.unique(keys // page)) == 1
    per_rank = [t[tiles % nsplit == r] for r in range(nsplit)]
    assert sorted(torch.cat(per_rank).tolist()) == list(range(T))
    assert all(len(keys) for keys in per_rank)      # no rank without a key of T
    # the kernel's cluster: the largest power of two <= 8 and the tile count
    ns, r = da.split_plan(T, page, 128, torch.bfloat16)
    n = int(da.key_tiles(T, page, r)[-1]) + 1
    assert ns & (ns - 1) == 0 and ns <= min(8, n) < 2 * ns
    assert da.split_plan(4096, 128, 128, torch.bfloat16) == (8, 32)     # serve
    assert da.split_plan(4096, 16, 128, torch.float32) == (8, 16)       # fp32, page 16
    assert da.split_plan(64, 64, 64, torch.bfloat16) == (1, 64)         # one tile


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("label", ["serve", "gqa", "full", "skew"])
def test_split_reference_within_the_card_gate(dtype, label):
    """In bf16/fp16 the split arithmetic (P rounded unnormalised, per rank)
    meets the gate the card holds K4 to against the plain version
    (``chip_smoke.DECODE_TOL``, worst row and per element), and the gate
    still rejects the lower-precision yardstick: the tolerance leaves room
    for the kernel's arithmetic and no more.  Four heads of the cases'
    width and length."""
    from chip_smoke import DECODE_CASES, DECODE_TOL, decode_compare, decode_low_precision

    case = next(c for c in DECODE_CASES if c[0] == label)
    _, B, Hq, Hkv, hd, _, page, maxp = case
    Hq, Hkv = 4, max(1, 4 * Hkv // Hq)
    T = page * maxp
    lengths = {"full": [T - 1] * B, "skew": [T - 1] + [1] * (B - 1)}.get(
        label, [1249, 84, 82, 690, 153, 241, 886, 61])
    rs = np.random.RandomState(7)
    q, k, v, table = _paged_case(rs, B, Hq, Hkv, hd, page, maxp, lengths)
    tq, tk, tv = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    tt = torch.from_numpy(table)
    mask = (torch.arange(T)[None] <= torch.tensor(lengths)[:, None]).to(torch.int32)
    got = da.decode_attention_split_reference(tq, tk, tv, mask, tt)
    ref = da.decode_attention_reference(tq, tk, tv, mask, tt)
    low = decode_low_precision(tq, tk, tv, mask, tt)
    reading = decode_compare(got, ref, low, Hq // Hkv, DECODE_TOL[dtype])
    assert reading["ok"] and reading["yardsticks_rejected"], reading
