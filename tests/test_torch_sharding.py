"""The port's sharding rules (`repro_torch.train.sharding`) against the
reference's (`repro.train.sharding`), with no ranks: both read only a
mesh's axis names and sizes, so they are asked on duck-typed meshes.
Every parameter of every architecture, reduced and at full size, under
the default, decode, long-context and pure-EP rules, on the reference's
TPU shapes (16, 16) and (2, 16, 16) and the port's H100 shapes (32, 8)
and (2, 32, 8): the per-dimension answer (an axis name, a tuple of
names, or None) must be the reference's PartitionSpec entry for entry.
"""
import types

import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs import base
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer
from repro_torch.train import sharding as shd

MESHES = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model"),
          mesh_lib.PRODUCTION_SHAPE: ("data", "model"),
          mesh_lib.MULTI_POD_SHAPE: ("pod", "data", "model")}
RULESETS = {"default": None, "decode": shd.DECODE_OVERRIDES,
            "long": shd.LONG_CONTEXT_OVERRIDES,
            "pure_ep": {"experts": "model"}}
LOGICAL = ("batch", "seq", "res_seq", "cache_seq", "heads", "kv_heads",
           "heads_flat", "ff", "experts", "vocab", "embed", "embed_fsdp",
           "d_inner", "state", None)


def duck(shape):
    names = MESHES[shape]
    return types.SimpleNamespace(axis_names=names,
                                 shape=dict(zip(names, shape)))


@pytest.fixture(scope="module")
def rsh():
    from repro.train import sharding
    return sharding


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), tuple(v.shape)


def test_tables_are_the_references(rsh):
    for name in ("DEFAULT_RULES", "DECODE_OVERRIDES", "LONG_CONTEXT_OVERRIDES",
                 "PARAM_LOGICAL", "PARAM_LOGICAL_EP"):
        assert getattr(shd, name) == getattr(rsh, name), name


@pytest.mark.parametrize("shape", list(MESHES))
@pytest.mark.parametrize("rules", list(RULESETS))
def test_rules_and_param_specs_equal_the_references(rsh, shape, rules):
    mesh = duck(shape)
    ov = RULESETS[rules]
    got_rules = shd.make_rules(mesh, ov)
    assert got_rules == rsh.make_rules(mesh, ov)
    assert shd.pure_ep(got_rules) == rsh.pure_ep(got_rules) \
        == (rules == "pure_ep")
    # every logical name, with and without a shape that a rule must drop
    for dims in ((8, 4096), (6, 24)):
        for a in LOGICAL:
            for b in LOGICAL:
                want = tuple(rsh.logical_spec((a, b), mesh, got_rules, dims))
                assert shd.logical_spec((a, b), mesh, got_rules, dims) \
                    == want, (a, b, dims)
    n = 0
    for arch in base.list_archs():
        for cfg in (base.get_arch(arch), base.get_arch(arch).reduced()):
            for path, lshape in _leaves(transformer.init_params(None, cfg)):
                want = tuple(rsh.param_spec_for(path, lshape, mesh,
                                                got_rules))
                got = shd.param_spec_for(path, lshape, mesh, got_rules)
                assert got == want, (cfg.name, path, lshape, got, want)
                n += 1
    assert n == 492         # 11 archs x (full, reduced)


def test_placements_hand_cases():
    mesh = duck((2, 32, 8))
    assert shd.placements((None, None), mesh) == (Replicate(),) * 3
    assert shd.placements((("pod", "data"), "model"), mesh) == (
        Shard(0), Shard(0), Shard(1))
    assert shd.placements((None, "data", None, "model"), mesh) == (
        Replicate(), Shard(1), Shard(3))
    assert shd.placements(("model",), duck((32, 8))) == (Replicate(),
                                                         Shard(0))
    with pytest.raises(ValueError, match="axis order"):
        shd.placements((("model", "data"),), duck((32, 8)))
    with pytest.raises(ValueError, match="shards two"):
        shd.placements(("data", "data"), duck((32, 8)))


def test_tree_param_specs_follow_the_rules():
    """Stacked block parameters keep their block dimension whole; the
    qwen3-0.6b tree on the H100 mesh, by hand."""
    cfg = base.get_arch("qwen3-0.6b")
    specs = shd.tree_param_specs(transformer.init_params(None, cfg),
                                 duck(mesh_lib.PRODUCTION_SHAPE))
    attn = specs["blocks"]["pos0"]["mixer"]
    assert attn["wq"] == (Shard(1), Shard(2))      # (nb, d, h·hd)
    assert attn["wo"] == (Shard(2), Shard(1))      # (nb, h·hd, d)
    assert attn["q_norm"] == (Replicate(), Replicate())
    assert specs["embedding"] == (Shard(1), Shard(0))   # (vocab, d)
    assert specs["lm_head"] == (Shard(0), Shard(1))     # (d, vocab)
    assert specs["final_norm"] == (Replicate(), Replicate())


def test_shard_is_the_identity_off_the_mesh():
    x = torch.randn(4, 6)
    assert shd.shard(x, ("batch", "seq")) is x
    with shd.use_mesh_rules(duck((32, 8))):      # a plain tensor on a mesh
        assert shd.shard(x, ("batch", "seq")) is x
    assert shd._mesh() is None and shd._rules() is None
