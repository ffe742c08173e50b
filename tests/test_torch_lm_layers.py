"""The port's LM building blocks against the reference's, function by
function, in float32 on the CPU: `models/layers.py` (norm, RoPE in its
three styles, qk-norm, blocked and sliding-window attention, decode at
ragged cache lengths, SwiGLU), `models/moe.py` (routing, capacity drops,
the combine), `models/rwkv.py` and `models/mamba.py`.

Parameters are the reference's own init (`jax.random`), carried across as
numpy arrays; inputs are drawn from seeded numpy generators.  Tolerance is
atol = rtol = 1e-5, except for the RWKV chunk scan and the Mamba time scan,
held to 1e-4: both carry a float32 state through exp() of accumulated
decays over every position (RWKV's inter-chunk state reaches magnitudes of
~10, and a last-bit difference in a cumsum or an exp moves its products by
a few 1e-6 relative), and the two libraries contract the scans' einsums
in different orders.
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_harness import reference_lm

from repro_torch.configs.base import get_arch
from repro_torch.models import layers, mamba, moe, rwkv

TOL = dict(atol=1e-5, rtol=1e-5)
SCAN_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def ref():
    return reference_lm()


def _cfgs(name, **kw):
    """The reduced config of `name` in both packages, float32, with `kw`."""
    from repro.configs.base import get_arch as ref_get
    rc = dataclasses.replace(ref_get(name).reduced(), dtype="float32", **kw)
    pc = dataclasses.replace(get_arch(name).reduced(), dtype="float32", **kw)
    return rc, pc


def _params(ref, init, rc, seed=0):
    """A reference init's tree as (jax tree, torch tree)."""
    p = init(ref.jax.random.PRNGKey(seed), rc)
    return p, _torch(p)


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _x(shape, seed=1, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale) \
        .astype(np.float32)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), **tol)


def _pos(B, S, start=0):
    p = np.broadcast_to(np.arange(start, start + S)[None], (B, S))
    return p.astype(np.int32), torch.from_numpy(p.astype(np.int64))


# ---------------------------------------------------------------------------
# norm, positions, projections
# ---------------------------------------------------------------------------

def test_rms_norm(ref):
    x, s = _x((3, 5, 64)), _x((64,), seed=2)
    _close(ref.layers.rms_norm(ref.jnp.asarray(x), ref.jnp.asarray(s), 1e-5),
           layers.rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-5))


@pytest.mark.parametrize("style", ["full", "half", "none"])
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope(ref, style, theta):
    """Interleaved pairs, rotated over all (full) or half (GLM) the dims,
    at positions past 1024."""
    B, S, H, hd = 2, 9, 3, 64
    x = _x((B, S, H, hd))
    pj, pt = _pos(B, S, start=1100)
    rot = hd if style == "full" else hd // 2
    sj, cj = ref.layers.rope_angles(ref.jnp.asarray(pj), rot, theta)
    st, ct = layers.rope_angles(pt, rot, theta)
    _close(sj, st)
    _close(cj, ct)
    _close(ref.layers.apply_rope(ref.jnp.asarray(x), sj, cj, style),
           layers.apply_rope(torch.from_numpy(x), st, ct, style))


def test_sinusoidal_emb(ref):
    pj, pt = _pos(2, 7, start=40)
    _close(ref.layers.sinusoidal_emb(ref.jnp.asarray(pj), 96),
           layers.sinusoidal_emb(pt, 96))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "chatglm3-6b",
                                  "musicgen-medium"])
def test_qkv(ref, arch):
    """qk-norm before RoPE (qwen3), half RoPE (GLM), no RoPE (musicgen)."""
    rc, pc = _cfgs(arch)
    pj, ptree = _params(ref, ref.layers.init_attention, rc)
    x = _x((2, 11, rc.d_model))
    posj, post = _pos(2, 11, start=3)
    got = layers._qkv(ptree, torch.from_numpy(x), pc, post)
    want = ref.layers._qkv(pj, ref.jnp.asarray(x), rc, ref.jnp.asarray(posj))
    for a, b in zip(want, got):
        _close(a, b)


def test_mlp(ref):
    rc, pc = _cfgs("granite-3-2b")
    pj, ptree = _params(ref, ref.layers.init_mlp, rc)
    x = _x((2, 5, rc.d_model))
    _close(ref.layers.mlp(pj, ref.jnp.asarray(x)),
           layers.mlp(ptree, torch.from_numpy(x)))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,S,window", [
    ("llama3-8b", 40, 0),              # one block
    ("qwen3-0.6b", 40, 0),             # qk-norm
    ("llava-next-mistral-7b", 40, 8),  # sliding window
    ("chatglm3-6b", 1100, 0),          # _pick_q_block: several blocks
    ("llama3-8b", 1100, 300),          # several blocks, window lower bound
])
def test_attention_prefill(ref, arch, S, window):
    rc, pc = _cfgs(arch, sliding_window=window)
    assert (layers._pick_q_block(S) < S) == (S > 1024)
    pj, ptree = _params(ref, ref.layers.init_attention, rc)
    B = 1 if S > 1024 else 2
    x = _x((B, S, rc.d_model))
    posj, post = _pos(B, S)
    oj, (kj, vj) = ref.layers.attention(pj, ref.jnp.asarray(x), rc,
                                        ref.jnp.asarray(posj))
    ot, (kt, vt) = layers.attention(ptree, torch.from_numpy(x), pc, post)
    _close(oj, ot)
    _close(kj, kt)
    _close(vj, vt)


@pytest.mark.parametrize("arch,window", [("llama3-8b", 0),
                                         ("qwen3-0.6b", 0),
                                         ("llava-next-mistral-7b", 6)])
def test_attention_decode_ragged(ref, arch, window):
    """Rows at different cache lengths, one past the end of the cache
    (which writes nothing); the cache comes back written in place."""
    rc, pc = _cfgs(arch, sliding_window=window)
    pj, ptree = _params(ref, ref.layers.init_attention, rc)
    B, S = 4, 24
    ck = _x((B, S, rc.num_kv_heads, rc.hd), seed=3)
    cv = _x((B, S, rc.num_kv_heads, rc.hd), seed=4)
    lens = np.array([0, 7, 23, 24], np.int32)
    x = _x((B, 1, rc.d_model))
    oj, (ckj, cvj) = ref.layers.attention_decode(
        pj, ref.jnp.asarray(x), rc, (ref.jnp.asarray(ck), ref.jnp.asarray(cv)),
        ref.jnp.asarray(lens))
    ckt, cvt = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    ot, (ck2, cv2) = layers.attention_decode(
        ptree, torch.from_numpy(x), pc, (ckt, cvt),
        torch.from_numpy(lens.astype(np.int64)))
    assert ck2 is ckt and cv2 is cvt
    _close(oj, ot)
    _close(ckj, ckt)
    _close(cvj, cvt)
    np.testing.assert_array_equal(ckt[3].numpy(), ck[3])


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,cf", [("olmoe-1b-7b", 8.0),
                                     ("olmoe-1b-7b", 0.25),
                                     ("dbrx-132b", 1.25)])
def test_moe(ref, arch, cf):
    """Routing (expert ids equal), capacity drops (cf = 0.25 drops
    entries) and the combine, against the reference's shard-local path."""
    rc, pc = _cfgs(arch, capacity_factor=cf)
    pj, ptree = _params(ref, ref.moe.init_moe, rc)
    B, S = 2, 16
    x = _x((B, S, rc.d_model))
    oj, auxj = ref.moe.moe_ffn(pj, ref.jnp.asarray(x), rc)
    ot, auxt = moe.moe_ffn(ptree, torch.from_numpy(x), pc)
    _close(oj, ot)
    np.testing.assert_allclose(float(auxj), float(auxt), **TOL)

    xt = torch.from_numpy(x).reshape(B * S, -1)
    _, gate, eidx, _ = moe.route(ptree, xt, pc)
    cap = moe.capacity(B * S, pc)
    _, meta, _ = ref.moe._route_local(ref.jnp.asarray(x.reshape(B * S, -1)),
                                      pj, rc, cap)
    st, sg, slot_e, slot_c, keep = (np.asarray(a) for a in meta)
    order, pe, pcs, pk = moe.dispatch(eidx, cap, pc.num_experts)
    np.testing.assert_array_equal(st, (order // pc.num_experts_per_tok)
                                  .numpy())
    np.testing.assert_array_equal(slot_e, pe.numpy())
    np.testing.assert_array_equal(slot_c, pcs.numpy())
    np.testing.assert_array_equal(keep, pk.numpy())
    np.testing.assert_allclose(sg, gate.reshape(-1)[order].numpy(), **TOL)
    assert keep.all() == (cf > 1)            # cf = 0.25 drops entries


# ---------------------------------------------------------------------------
# RWKV
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,with_state", [(45, False), (32, False),
                                          (7, True), (70, True)])
def test_rwkv_timemix(ref, S, with_state):
    """The chunk-32 scan at S not a multiple of 32 (padded last chunk),
    one whole chunk, and from a carried state."""
    rc, pc = _cfgs("rwkv6-7b")
    pj, ptree = _params(ref, ref.rwkv.init_timemix, rc)
    B, D = 2, rc.d_model
    H, N = rc.num_heads, D // rc.num_heads
    x = _x((B, S, D))
    state = None
    if with_state:
        state = (_x((B, D), seed=5), _x((B, H, N, N), seed=6, scale=0.1))
    oj, (xj, sj) = ref.rwkv.timemix(
        pj, ref.jnp.asarray(x), rc,
        None if state is None else tuple(map(ref.jnp.asarray, state)))
    ot, (xt, stt) = rwkv.timemix(
        ptree, torch.from_numpy(x), pc,
        None if state is None else tuple(map(torch.from_numpy, state)))
    _close(oj, ot, SCAN_TOL)
    _close(xj, xt)
    _close(sj, stt, SCAN_TOL)


def test_rwkv_decode_and_channelmix(ref):
    rc, pc = _cfgs("rwkv6-7b")
    pj, ptree = _params(ref, ref.rwkv.init_timemix, rc)
    cj, ctree = _params(ref, ref.rwkv.init_channelmix, rc, seed=1)
    B, D = 3, rc.d_model
    H, N = rc.num_heads, D // rc.num_heads
    x = _x((B, 1, D))
    st = (_x((B, D), seed=5), _x((B, H, N, N), seed=6, scale=0.1))
    oj, (xj, sj) = ref.rwkv.timemix_decode(pj, ref.jnp.asarray(x), rc,
                                           tuple(map(ref.jnp.asarray, st)))
    ot, (xt, stt) = rwkv.timemix_decode(ptree, torch.from_numpy(x), pc,
                                        tuple(map(torch.from_numpy, st)))
    _close(oj, ot)
    _close(xj, xt)
    _close(sj, stt)
    xs = _x((B, 9, D), seed=7)
    prev = _x((B, D), seed=8)
    for p in (None, prev):
        fj, lj = ref.rwkv.channelmix(cj, ref.jnp.asarray(xs), rc,
                                     None if p is None else ref.jnp.asarray(p))
        ft, lt = rwkv.channelmix(ctree, torch.from_numpy(xs), pc,
                                 None if p is None else torch.from_numpy(p))
        _close(fj, ft)
        _close(lj, lt)
    g = _x((D,), seed=9)
    _close(ref.rwkv._group_norm(ref.jnp.asarray(xs), ref.jnp.asarray(g), H),
           rwkv._group_norm(torch.from_numpy(xs), torch.from_numpy(g), H))


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_conv_causal(ref, with_state):
    rc, pc = _cfgs("jamba-1.5-large-398b")
    DI, K = mamba.d_inner(pc), pc.mamba_conv
    x, w, b = _x((2, 6, DI)), _x((K, DI), seed=2), _x((DI,), seed=3)
    cs = _x((2, K - 1, DI), seed=4) if with_state else None
    oj, sj = ref.mamba._conv_causal(
        *map(ref.jnp.asarray, (x, w, b)),
        None if cs is None else ref.jnp.asarray(cs))
    ot, stt = mamba._conv_causal(
        *map(torch.from_numpy, (x, w, b)),
        None if cs is None else torch.from_numpy(cs))
    _close(oj, ot)
    _close(sj, stt)


@pytest.mark.parametrize("S,with_state", [(13, False), (5, True),
                                          (1, True)])
def test_mamba(ref, S, with_state):
    """The float32 time scan, from zeros and from a carried (conv, h)
    state; S = 1 is `mamba_decode`."""
    rc, pc = _cfgs("jamba-1.5-large-398b")
    pj, ptree = _params(ref, ref.mamba.init_mamba, rc)
    B, D = 2, rc.d_model
    DI, NS, K = mamba.d_inner(pc), pc.mamba_d_state, pc.mamba_conv
    x = _x((B, S, D))
    st = None
    if with_state:
        st = (_x((B, K - 1, DI), seed=4), _x((B, DI, NS), seed=5, scale=0.1))
    fj = ref.mamba.mamba_decode if S == 1 else ref.mamba.mamba
    ft = mamba.mamba_decode if S == 1 else mamba.mamba
    oj, (cj, hj) = fj(pj, ref.jnp.asarray(x), rc,
                      None if st is None else tuple(map(ref.jnp.asarray, st)))
    ot, (ct, ht) = ft(ptree, torch.from_numpy(x), pc,
                      None if st is None else tuple(map(torch.from_numpy, st)))
    _close(oj, ot, SCAN_TOL)
    _close(cj, ct)
    _close(hj, ht, SCAN_TOL)


def test_ssm_scan(ref):
    B, S, DI, NS = 2, 9, 16, 4
    u = _x((B, S, DI))
    delta = np.abs(_x((B, S, DI), seed=2)) * 0.1
    A = -np.abs(_x((DI, NS), seed=3))
    Bm, Cm = _x((B, S, NS), seed=4), _x((B, S, NS), seed=5)
    Dc, h0 = _x((DI,), seed=6), _x((B, DI, NS), seed=7)
    args = (u, delta, A, Bm, Cm, Dc, h0)
    yj, hj = ref.mamba._ssm_scan(*map(ref.jnp.asarray, args), chunk=4)
    yt, ht = mamba._ssm_scan(*map(torch.from_numpy, args))
    _close(yj, yt, SCAN_TOL)
    _close(hj, ht, SCAN_TOL)
