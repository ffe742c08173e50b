"""Decoder LM assembly from ArchConfig: dense / MoE / RWKV / hybrid / audio /
VLM.  Ported from `repro.models.transformer`.

The parameter tree keeps the reference's layout: block parameters are
stacked along a leading block axis (`blocks/pos{i}/...`, (num_blocks, ...)),
one stack per position of `cfg.block_pattern`, so a checkpoint's flat keys
are the reference's.  Where the reference runs `lax.scan` over the stack,
`Transformer` loops over the blocks in Python and reads block b's
parameters as views of the stacks.

    model = Transformer(cfg, init_params(gen, cfg))       # on the card
    logits, aux, caches = model.forward(tokens, collect_cache=True)
    logits, caches = model.decode_step(caches, tok, cache_len)

Serving runs with the parameters' gradients off.  Training turns them on
with `model.requires_grad_(True)` (`repro_torch.train.step` does) and
calls `forward_hidden(..., remat=)`, which checkpoints each block as the
reference's scan body does.

`inputs` is tokens (B,S) int64 for input_mode="tokens", or precomputed
embeddings (B,S,D) for the audio/VLM stub frontends.  Decode updates the
cache tensors IN PLACE (the new k/v row, the recurrent states) and returns
the same tree: a functional copy of a 15 GB cache per step is not an
option on the card.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.device import resolve_device
from repro_torch.models import layers, mamba as mamba_lib, moe as moe_lib, \
    rwkv as rwkv_lib
from repro_torch.train import sharding as shd

EXPERT_WEIGHTS = ("we1", "we2", "we3")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_block_position(gen, cfg, mix: str, ffn: str, nb: int):
    dt = layers._dtype(cfg)
    lead = (nb,)
    p = {"norm1": layers.full(gen, (nb, cfg.d_model), 1.0, dt),
         "norm2": layers.full(gen, (nb, cfg.d_model), 1.0, dt)}
    if mix == "attn":
        p["mixer"] = layers.init_attention(gen, cfg, lead)
    elif mix == "mamba":
        p["mixer"] = mamba_lib.init_mamba(gen, cfg, lead)
    elif mix == "rwkv":
        p["mixer"] = rwkv_lib.init_timemix(gen, cfg, lead)
    else:
        raise ValueError(mix)
    if ffn == "dense":
        p["ffn"] = layers.init_mlp(gen, cfg, lead)
    elif ffn == "moe":
        p["ffn"] = moe_lib.init_moe(gen, cfg, lead)
    elif ffn == "channelmix":
        p["ffn"] = rwkv_lib.init_channelmix(gen, cfg, lead)
    else:
        raise ValueError(ffn)
    return p


def init_params(gen: Optional[torch.Generator], cfg) -> dict:
    """The reference's parameter tree (same keys, shapes, dtypes and
    scales), drawn from `gen` on its device.  Bit equality with
    `jax.random` is not a goal.  `gen=None` gives the tree on the meta
    device: shapes and dtypes only, for checking a checkpoint."""
    nb = cfg.num_blocks
    dt = layers._dtype(cfg)
    params = {"final_norm": layers.full(gen, (cfg.d_model,), 1.0, dt)}
    if cfg.input_mode == "tokens":
        params["embedding"] = layers.normal(
            gen, (cfg.vocab_size, cfg.d_model), 0.02, dt)
    params["lm_head"] = layers.normal(
        gen, (cfg.d_model, cfg.vocab_size), 1.0 / math.sqrt(cfg.d_model), dt)
    params["blocks"] = {
        f"pos{i}": _init_block_position(gen, cfg, mix, ffn, nb)
        for i, (mix, ffn) in enumerate(cfg.block_pattern)}
    return params


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: each dict a child module, each
    tensor a parameter (no gradient while serving).  `tree[name]` reads a
    child or a tensor, as the layer functions index the reference's dicts;
    `tree.unbind()[b]` is block b's slice of every stacked tensor."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(
                    k, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, k):
        return getattr(self, k)

    def __contains__(self, k) -> bool:
        return k in self._parameters or k in self._modules

    def unbind(self) -> list:
        """Every block's slice of every stacked tensor, from one
        `unbind(0)` per stack: under autograd its backward is one `stack`
        per stack, where a select per block would each add a zero tensor
        the size of the whole stack into the gradient."""
        per = {k: v.unbind(0) for k, v in self._parameters.items()}
        per.update((k, m.unbind()) for k, m in self._modules.items())
        nb = len(next(iter(per.values())))
        return [{k: v[b] for k, v in per.items()} for b in range(nb)]

    def tree(self) -> dict:
        """The parameters as the reference's nested dict (the tensors
        themselves, not copies)."""
        out = dict(self._parameters)
        out.update((k, m.tree()) for k, m in self._modules.items())
        return out


def _save_matmuls(ctx, op, *args, **kwargs):
    """The `dots` remat policy, JAX's `checkpoint_dots_with_no_batch_dims`:
    keep the outputs of products without batch dimensions (`x @ w`
    reaches the dispatcher as `mm`), recompute everything else (the
    attention and expert `bmm`s included)."""
    if op is torch.ops.aten.mm.default:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


class Transformer(nn.Module):
    """The LM: `cfg` plus its parameter tree, on one device.

    `device`: None means CUDA and raises without a GPU; "cpu" runs the
    plain path on the host.  The tree's tensors are moved there."""

    def __init__(self, cfg, params: dict, device=None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = ParamTree(params)
        if any(p.device != self.device and not shd.is_sharded(p)
               for p in self.params.parameters()):
            # (a tree on a mesh was placed by `distribute_tensor`)
            self.params = self.params.to(self.device)

    # -- forward (prefill) --------------------------------------------------

    def _embed(self, inputs, positions):
        cfg = self.cfg
        if cfg.input_mode == "tokens":
            emb = shd.gather_fsdp(self.params["embedding"], "embedding")
            # on a mesh, `embedding` keeps the vocab shards (each rank
            # looks up its own rows and the partial rows are summed);
            # DTensor would gather the whole table for an index
            x = F.embedding(inputs, emb) if shd.is_sharded(emb) \
                else emb[inputs]                              # (B,S,D) gather
        else:
            x = inputs.to(layers._dtype(cfg))   # precomputed embeddings
        if cfg.pos_style == "sinusoidal":
            x = x + layers.sinusoidal_emb(positions, cfg.d_model).to(x.dtype)
        return shd.shard(x, ("batch", "res_seq", None))

    def forward_hidden(self, inputs, positions=None,
                       collect_cache: bool = False, remat: str = "none"):
        """Backbone only: returns (final hidden (B,S,D), aux_loss, caches).

        `remat` ("none" | "full" | "dots") checkpoints EACH BLOCK, as the
        reference's scan body: backward recomputes one block at a time,
        so the activations kept are the per-block carries plus one
        block's transients.  "full" keeps nothing of a block, "dots" its
        products without batch dimensions.  Each stack's block views come
        from one `unbind` and enter the checkpointed block as inputs."""
        cfg = self.cfg
        B, S = inputs.shape[:2]
        if positions is None:
            positions = torch.arange(S, device=self.device)[None].expand(B, S)
            if shd.is_sharded(inputs):     # laid out as the tokens are
                positions = shd.distribute(positions, inputs.device_mesh,
                                           inputs.placements)
        x = self._embed(inputs, positions)
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        body = functools.partial(self._block, positions=positions,
                                 collect_cache=collect_cache)
        if remat == "full":
            body = functools.partial(ckpt.checkpoint, body,
                                     use_reentrant=False)
        elif remat == "dots":
            body = functools.partial(
                ckpt.checkpoint, body, use_reentrant=False,
                context_fn=functools.partial(
                    ckpt.create_selective_checkpoint_contexts,
                    _save_matmuls))
        elif remat != "none":
            raise ValueError(f"remat must be none, full or dots: {remat!r}")
        per_block = []
        for bp in self.params["blocks"].unbind():
            x, aux, caches = body(x, aux, bp)
            if collect_cache:
                per_block.append(caches)
        x = layers.rms_norm(x, self.params["final_norm"], cfg.norm_eps)
        if not collect_cache:
            return x, aux, None
        stacked = {pos: {name: torch.stack([c[pos][name] for c in per_block])
                         for name in per_block[0][pos]}
                   for pos in per_block[0]}
        return x, aux, stacked

    def _block(self, x, aux, bp, positions, collect_cache):
        """One block of `cfg.block_pattern` on block parameters `bp`:
        returns (x, aux, caches, empty unless `collect_cache`)."""
        cfg = self.cfg
        caches = {}
        bp = shd.gather_fsdp(bp)
        for i, (mix, ffn) in enumerate(cfg.block_pattern):
            pp = bp[f"pos{i}"]
            h = layers.rms_norm(x, pp["norm1"], cfg.norm_eps)
            if mix == "attn":
                mo, kv = layers.attention(pp["mixer"], h, cfg, positions)
                cch = {"k": kv[0], "v": kv[1]}
            elif mix == "mamba":
                mo, st = mamba_lib.mamba(pp["mixer"], h, cfg)
                cch = {"conv": st[0], "h": st[1]}
            else:  # rwkv
                mo, st = rwkv_lib.timemix(pp["mixer"], h, cfg)
                cch = {"x_tm": st[0], "S": st[1]}
            x = x + mo
            h2 = layers.rms_norm(x, pp["norm2"], cfg.norm_eps)
            if ffn == "dense":
                f = layers.mlp(pp["ffn"], h2)
            elif ffn == "moe":
                f, al = moe_lib.moe_ffn(pp["ffn"], h2, cfg)
                aux = aux + al
            else:  # channelmix
                f, xcm = rwkv_lib.channelmix(pp["ffn"], h2, cfg)
                cch["x_cm"] = xcm
            # (the FFN's row-parallel product ends as a partial sum)
            f = shd.shard(f, ("batch", "seq", None))
            x = shd.shard(x + f, ("batch", "res_seq", None))
            if collect_cache:
                caches[f"pos{i}"] = cch
        return x, aux, caches

    def project_logits(self, x):
        head = shd.gather_fsdp(self.params["lm_head"], "lm_head")
        return shd.shard(x @ head,
                         ("batch", "seq", "vocab"))

    def forward(self, inputs, positions=None, collect_cache: bool = False):
        """Returns (logits, aux_loss, caches_or_None)."""
        x, aux, caches = self.forward_hidden(inputs, positions, collect_cache)
        return self.project_logits(x), aux, caches

    # -- decode (one token, cache of max_seq) -------------------------------

    def decode_step(self, caches, inputs, cache_len):
        """inputs: tokens (B,1) or embeddings (B,1,D); cache_len: (B,) int.

        Returns (logits (B,1,V), caches), the caches updated in place."""
        cfg = self.cfg
        positions = cache_len[:, None]
        x = self._embed(inputs, positions)
        for b, bp in enumerate(self.params["blocks"].unbind()):
            bp = shd.gather_fsdp(bp)
            for i, (mix, ffn) in enumerate(cfg.block_pattern):
                pp, cc = bp[f"pos{i}"], caches[f"pos{i}"]
                h = layers.rms_norm(x, pp["norm1"], cfg.norm_eps)
                if mix == "attn":
                    mo, _ = layers.attention_decode(
                        pp["mixer"], h, cfg, (cc["k"][b], cc["v"][b]),
                        cache_len)
                elif mix == "mamba":
                    mo, st = mamba_lib.mamba_decode(
                        pp["mixer"], h, cfg, (cc["conv"][b], cc["h"][b]))
                    cc["conv"][b], cc["h"][b] = st
                else:
                    mo, st = rwkv_lib.timemix_decode(
                        pp["mixer"], h, cfg, (cc["x_tm"][b], cc["S"][b]))
                    cc["x_tm"][b], cc["S"][b] = st
                x = x + mo
                h2 = layers.rms_norm(x, pp["norm2"], cfg.norm_eps)
                if ffn == "dense":
                    f = layers.mlp(pp["ffn"], h2)
                elif ffn == "moe":
                    f, _ = moe_lib.moe_ffn(pp["ffn"], h2, cfg)
                else:
                    f, xcm = rwkv_lib.channelmix(pp["ffn"], h2, cfg,
                                                 cc["x_cm"][b])
                    cc["x_cm"][b] = xcm
                x = x + f
        x = layers.rms_norm(x, self.params["final_norm"], cfg.norm_eps)
        return self.project_logits(x), caches


def param_count(model: Transformer) -> int:
    return sum(p.numel() for p in model.params.parameters())


def active_param_count(model: Transformer) -> int:
    """Params touched per token (MoE experts scaled by top-k/E)."""
    cfg = model.cfg
    total = 0
    for name, leaf in model.params.named_parameters():
        n = leaf.numel()
        if name.rsplit(".", 1)[-1] in EXPERT_WEIGHTS and cfg.num_experts:
            n = n * cfg.num_experts_per_tok // cfg.num_experts
        total += n
    return total


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_seq: int, device=None) -> dict:
    """Zero caches in the reference's layout and dtypes: k/v and the conv
    and token-shift windows in the model dtype, recurrent states (Mamba h,
    RWKV S) in float32."""
    dev = resolve_device(device)
    nb = cfg.num_blocks
    dt = layers._dtype(cfg)
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    N = D // H
    f32 = torch.float32
    cache = {}
    for i, (mix, ffn) in enumerate(cfg.block_pattern):
        c = {}
        if mix == "attn":
            c["k"] = torch.zeros(nb, batch, max_seq, KV, hd, dtype=dt,
                                 device=dev)
            c["v"] = torch.zeros(nb, batch, max_seq, KV, hd, dtype=dt,
                                 device=dev)
        elif mix == "mamba":
            DI, NS, K = (mamba_lib.d_inner(cfg), cfg.mamba_d_state,
                         cfg.mamba_conv)
            c["conv"] = torch.zeros(nb, batch, K - 1, DI, dtype=dt,
                                    device=dev)
            c["h"] = torch.zeros(nb, batch, DI, NS, dtype=f32, device=dev)
        elif mix == "rwkv":
            c["x_tm"] = torch.zeros(nb, batch, D, dtype=dt, device=dev)
            c["S"] = torch.zeros(nb, batch, H, N, N, dtype=f32, device=dev)
        if ffn == "channelmix":
            c["x_cm"] = torch.zeros(nb, batch, D, dtype=dt, device=dev)
        cache[f"pos{i}"] = c
    return cache
