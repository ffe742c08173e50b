"""Every registered architecture's reduced variant, the port against the
reference on the CPU in float32: the configs field for field, the
parameter counts, `forward`, `prefill_step` and 8 chained `decode_step`s
(logits within atol = rtol = 1e-4, equal greedy tokens, equal caches),
and the port's own decode-from-empty against its full forward (the
reference's serving contract, `tests/test_models.py`).

The reference's parameters (its `init_params` from PRNGKey(0)) cross
through `checkpoint.io.from_reference_params`.
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_harness import reference_lm

from repro_torch.checkpoint import io
from repro_torch.configs import base
from repro_torch.launch.serve import pad_caches
from repro_torch.models import transformer
from repro_torch.serve import engine

ARCHS = ["chatglm3-6b", "dbrx-132b", "granite-3-2b", "jamba-1.5-large-398b",
         "llama3-8b", "llama3-8b-sw8k", "llava-next-mistral-7b",
         "musicgen-medium", "olmoe-1b-7b", "qwen3-0.6b", "rwkv6-7b"]
TOL = dict(atol=1e-4, rtol=1e-4)
B, P, G = 2, 12, 8


@pytest.fixture(scope="module")
def ref():
    return reference_lm()


def _pair(ref, arch):
    """(reference cfg, port cfg, reference params, port model)."""
    rc = ref.configs.get_arch(arch).reduced()
    pc = base.get_arch(arch).reduced()
    params = ref.transformer.init_params(ref.jax.random.PRNGKey(0), rc)
    model = io.from_reference_params(
        ref.jax.tree_util.tree_map(np.asarray, params), pc, device="cpu")
    return rc, pc, params, model


def _inputs(cfg, S, seed=1):
    """(numpy for the reference, torch for the port)."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        t = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        return t, torch.from_numpy(t.astype(np.int64))
    e = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    return e, torch.from_numpy(e)


def test_registry_matches_reference(ref):
    assert base.list_archs() == ref.configs.list_archs() == ARCHS
    assert base.INPUT_SHAPES == ref.configs.INPUT_SHAPES


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(ref, arch):
    rc, pc = ref.configs.get_arch(arch), base.get_arch(arch)
    for r, p in ((rc, pc), (rc.reduced(), pc.reduced())):
        assert dataclasses.asdict(r) == dataclasses.asdict(p)
        assert (r.hd, r.block_pattern, r.num_blocks,
                r.supports_long_context) == \
            (p.hd, p.block_pattern, p.num_blocks, p.supports_long_context)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_reference(ref, arch):
    rc, pc, params, model = _pair(ref, arch)
    assert transformer.param_count(model) == \
        ref.transformer.param_count(params)
    assert transformer.active_param_count(model) == \
        ref.transformer.active_param_count(params, rc)
    # the port's own init builds the same tree
    own = transformer.init_params(torch.Generator().manual_seed(0), pc)
    meta = io._flatten(transformer.init_params(None, pc))
    for key, t in io._flatten(own).items():
        assert (t.shape, t.dtype) == (meta[key].shape, meta[key].dtype), key
    assert set(meta) == {n.replace(".", "/")
                         for n, _ in model.params.named_parameters()}


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(ref, arch):
    jax, jnp = ref.jax, ref.jnp
    rc, pc, params, model = _pair(ref, arch)
    xr, xt = _inputs(rc, P + G)

    lg_r, aux_r, _ = jax.jit(
        lambda p, x: ref.transformer.forward(p, x, rc))(params, xr)
    lg_t, aux_t, _ = model.forward(xt)
    np.testing.assert_allclose(np.asarray(lg_r), lg_t.numpy(), **TOL)
    np.testing.assert_allclose(float(aux_r), float(aux_t), **TOL)

    last_r, cache_r = jax.jit(
        lambda p, x: ref.engine.prefill_step(p, x, rc))(params, xr[:, :P])
    last_t, cache_t = engine.prefill_step(model, xt[:, :P])
    np.testing.assert_allclose(np.asarray(last_r), last_t.numpy(), **TOL)
    cache_r = jax.tree_util.tree_map(
        lambda c: jnp.concatenate(
            [c, jnp.zeros(c.shape[:2] + (G,) + c.shape[3:], c.dtype)], axis=2)
        if c.ndim >= 4 and c.shape[2] == P else c, cache_r)
    cache_t = pad_caches(cache_t, G)

    decode_r = jax.jit(
        lambda p, c, t, n: ref.engine.decode_step(p, c, t, n, rc))
    lens_r = jnp.full((B,), P, jnp.int32)
    lens_t = torch.full((B,), P, dtype=torch.int64)
    for s in range(G):
        lg_r, cache_r = decode_r(params, cache_r, xr[:, P + s:P + s + 1],
                                 lens_r)
        lg_t, cache_t = engine.decode_step(model, cache_t,
                                           xt[:, P + s:P + s + 1], lens_t)
        lens_r, lens_t = lens_r + 1, lens_t + 1
        np.testing.assert_allclose(np.asarray(lg_r), lg_t.numpy(), **TOL)
        np.testing.assert_array_equal(
            np.asarray(ref.engine.greedy_sample(lg_r)),
            engine.greedy_sample(lg_t).numpy())
    assert set(cache_r) == set(cache_t)
    for pos in cache_r:
        assert set(cache_r[pos]) == set(cache_t[pos])
        for name, c in cache_r[pos].items():
            assert tuple(c.shape) == tuple(cache_t[pos][name].shape)
            np.testing.assert_allclose(np.asarray(c), cache_t[pos][name],
                                       **TOL)


@pytest.mark.parametrize("arch", ["llama3-8b", "rwkv6-7b",
                                  "jamba-1.5-large-398b", "olmoe-1b-7b",
                                  "musicgen-medium"])
def test_decode_from_empty_matches_forward(arch):
    """Decoding every position from an empty cache gives the full
    forward's logits (tolerance as the reference's own test)."""
    cfg = base.get_arch(arch).reduced()
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)   # no drops
    model = transformer.Transformer(
        cfg, transformer.init_params(torch.Generator().manual_seed(0), cfg),
        device="cpu")
    _, x = _inputs(cfg, 12)
    full, _, _ = model.forward(x)
    caches = transformer.init_cache(cfg, B, 12, device="cpu")
    lens = torch.zeros(B, dtype=torch.int64)
    outs = []
    for t in range(12):
        lg, caches = model.decode_step(caches, x[:, t:t + 1], lens)
        lens = lens + 1
        outs.append(lg)
    np.testing.assert_allclose(full.numpy(), torch.cat(outs, 1).numpy(),
                               atol=5e-3, rtol=1e-2)
