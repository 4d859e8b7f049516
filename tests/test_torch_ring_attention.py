"""The port's ring attention (``deepspeed_tpu_torch/ops/ring_attention.py``)
against the JAX package's ``ring_attention_sharded`` on the 8-device CPU
mesh and against dense attention, in fp64 at 5e-6 (the golden gate's
tolerance; JAX's ring with its einsum block, which is fp64 throughout:
its Pallas flash block rounds inside the kernel, 7.3e-6 from the einsum
block in dk at the GQA case), on gloo ranks (``tests/_torch_ranks.py``, one spawn a world,
each under its own deadline): causal and full attention, MHA and GQA,
the einsum block and the flash block (its plain version on the CPU:
``S/sp`` a multiple of 128), outputs and the gradients of the sum of
squares, at ``sp`` = 2 and 4 (and sp=2 x dp=2).  The mirror of
``tests/unit/test_ring_attention.py``.

The virtual ring (``ring_attention_virtual``: ``sp`` ranks in one
process, the rotation a list index, what ``chip_smoke.py`` runs on one
card) runs the same schedule: checked against dense attention, with its
block calls counted (the skipped future blocks: ``sp`` causal and
``sp(sp-1)/2`` non-causal flash calls at ``sp`` = 4).
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.ops.ring_attention import ring_attention_sharded as jax_ring
from deepspeed_tpu.parallel import mesh as jmesh
from deepspeed_tpu_torch.ops import ring_attention as ra

from ._torch_ranks import run_ranks

TOL = dict(rtol=5e-6, atol=5e-6)
DEADLINE = 90.0
B, S, HD = 4, 512, 16


def _qkv(hq, hkv, seed):
    rs = np.random.RandomState(seed)
    return (rs.standard_normal((B, S, hq, HD)), rs.standard_normal((B, S, hkv, HD)),
            rs.standard_normal((B, S, hkv, HD)))


QKV = {"mha": _qkv(4, 4, 0), "gqa": _qkv(8, 2, 1)}
# (sp, causal, impl, heads) per world; dp = world / sp
CASES = {2: [(2, True, "einsum", "mha"), (2, False, "einsum", "mha"),
             (2, True, "flash", "mha"), (2, False, "flash", "mha"),
             (2, True, "einsum", "gqa"), (2, True, "flash", "gqa")],
         4: [(4, True, "einsum", "mha"), (4, False, "flash", "mha"),
             (4, True, "flash", "mha"), (4, True, "einsum", "gqa"),
             (4, True, "flash", "gqa"), (2, True, "flash", "mha")]}
IDS = [(w, i) for w in (2, 4) for i in range(len(CASES[w]))]


def _name(w, i):
    sp, causal, impl, heads = CASES[w][i]
    return f"w{w}-sp{sp}-{'causal' if causal else 'full'}-{impl}-{heads}"


@pytest.fixture(scope="module")
def ring_runs(tmp_path_factory):
    out = {}
    for world in (2, 4):
        cases = [{"sp": sp, "causal": c, "impl": impl, "qkv": QKV[h]}
                 for sp, c, impl, h in CASES[world]]
        out[world] = run_ranks(world, "ring", tmp_path_factory.mktemp(f"ring{world}"),
                               timeout=DEADLINE, cases=cases, q=None, k=None, v=None)
    return out


def _assemble(ranks, i, key):
    """The global array of ``key`` from every rank's (rows, cols) piece."""
    first = ranks[0][i][key]
    full = np.zeros((B, S) + first.shape[2:])
    for rank in ranks:
        got = rank[i]
        (r0, r1), (c0, c1) = got["rows"], got["cols"]
        full[r0:r1, c0:c1] = got[key]
    return full


def _dense(q, k, v, causal):
    G = q.shape[2] // k.shape[2]
    k, v = np.repeat(k, G, 2), np.repeat(v, G, 2)
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if causal:
        s = np.where(np.tril(np.ones((S, S), bool)), s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, v)


@pytest.fixture(scope="module")
def jax_refs():
    """JAX's ring on the 8-device CPU mesh (its einsum block) and dense
    attention, outputs and gradients of the sum of squares, in fp64."""
    out = {}
    jax.config.update("jax_enable_x64", True)
    try:
        for w, i in IDS:
            sp, causal, _, heads = CASES[w][i]
            impl = "einsum"
            q, k, v = (jnp.asarray(x) for x in QKV[heads])
            jmesh.reset_mesh()
            mesh = jmesh.initialize_mesh(jmesh.MeshLayout(sp=sp, dp=8 // sp))

            def loss(q, k, v):
                return jnp.sum(jax_ring(q, k, v, mesh, ("data", "expert"),
                                        causal=causal, impl=impl) ** 2)

            o = jax.jit(lambda q, k, v: jax_ring(q, k, v, mesh, ("data", "expert"),
                                                 causal=causal, impl=impl))(q, k, v)
            g = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
            out[(w, i)] = {"out": np.asarray(o), "grads": [np.asarray(x) for x in g]}
    finally:
        jax.config.update("jax_enable_x64", False)
        jmesh.reset_mesh()
    return out


@pytest.mark.parametrize("w,i", IDS, ids=[_name(w, i) for w, i in IDS])
def test_ring_matches_jax_and_dense(ring_runs, jax_refs, w, i):
    """The assembled output against JAX's ring and dense attention."""
    sp, causal, impl, heads = CASES[w][i]
    got = _assemble(ring_runs[w], i, "out")
    np.testing.assert_allclose(got, jax_refs[(w, i)]["out"], **TOL)
    np.testing.assert_allclose(got, _dense(*QKV[heads], causal), **TOL)


@pytest.mark.parametrize("w,i", IDS, ids=[_name(w, i) for w, i in IDS])
def test_ring_gradients_match_jax(ring_runs, jax_refs, w, i):
    """dq, dk, dv of the global sum of squares (every block's backward,
    the lse cotangent folded into delta, the rotations back) against
    ``jax.grad`` of JAX's ring; every rank made sp-1 rotations."""
    sp = CASES[w][i][0]
    for key, want in zip(("dq", "dk", "dv"), jax_refs[(w, i)]["grads"]):
        np.testing.assert_allclose(_assemble(ring_runs[w], i, key), want,
                                   err_msg=key, **TOL)
    assert {r[i]["rotations"] for r in ring_runs[w]} == {sp - 1}


def _flash_counter(monkeypatch):
    calls = {"causal": 0, "full": 0}
    real = ra.flash_attention

    def counting(q, k, v, causal=True, **kw):
        calls["causal" if causal else "full"] += 1
        return real(q, k, v, causal=causal, **kw)

    monkeypatch.setattr(ra, "flash_attention", counting)
    return calls


@pytest.mark.parametrize("causal", [True, False])
def test_virtual_ring_matches_dense_and_skips_future_blocks(monkeypatch, causal):
    """``sp`` = 4 virtual ranks in one process: outputs and gradients
    against dense attention (torch autograd through the plain branch) at
    fp64 5e-6; the schedule calls the flash block 4 times causal and 6
    times full (causal: the 6 future blocks skipped), 4 + 12 without a
    mask."""
    calls = _flash_counter(monkeypatch)
    n = 4
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in QKV["gqa"])
    qs, ks, vs = (list(x.chunk(n, 1)) for x in (q, k, v))
    out = torch.cat(ra.ring_attention_virtual(qs, ks, vs, causal=causal), 1)
    (out ** 2).sum().backward()
    grads = [x.grad.clone() for x in (q, k, v)]
    assert calls == ({"causal": 4, "full": 6} if causal else {"causal": 0, "full": 16})
    for x in (q, k, v):
        x.grad = None
    kr, vr = (x.repeat_interleave(4, 2) for x in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, kr) / math.sqrt(HD)
    if causal:
        s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), -1e30)
    ref = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vr)
    (ref ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), **TOL)
    for g, x in zip(grads, (q, k, v)):
        np.testing.assert_allclose(g.numpy(), x.grad.numpy(), **TOL)


def test_ring_impl_selection():
    """``auto`` takes the flash block on 128-multiple shards; ``flash`` on
    another shard raises JAX's error."""
    assert ra.flash_ok(128) and ra.flash_ok(4096) and not ra.flash_ok(64)
    assert ra._impl("auto", 128) == "flash" and ra._impl("auto", 64) == "einsum"
    with pytest.raises(ValueError, match="128-multiple"):
        ra._impl("flash", 64)
    with pytest.raises(ValueError, match="impl"):
        ra._impl("pallas", 128)
    q = torch.zeros(1, 64, 2, 16)
    with pytest.raises(ValueError, match="128-multiple"):
        ra.ring_attention_virtual([q, q], [q, q], [q, q], impl="flash")
