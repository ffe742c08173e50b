"""Serving entry point: prefill + greedy decode for a selected architecture,
ported from `repro.launch.serve`.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --smoke --device cpu

Runs on the card unless `--device cpu` is given.  `--smoke` serves the
architecture's reduced (2-layer, float32) variant.  Weights are drawn from
`--seed`; no real checkpoint ships with the repository.  `run` does the
work and returns the generated tokens with the prefill and per-step times
(each step ends in a device sync), for `chip_smoke.py` and the tests.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import get_arch
from repro_torch.device import resolve_device
from repro_torch.models import layers, transformer
from repro_torch.serve import engine


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def pad_caches(caches: dict, extra: int) -> dict:
    """Extend every attention cache (`k`, `v`: (nb, B, S, KV, hd)) by
    `extra` zero positions along S; recurrent states are left as they
    are.  (The reference pads any cache of ndim >= 4 whose third axis
    equals the prompt length, which also catches an RWKV `S` or a Mamba
    `h` of that width.)"""
    out = {}
    for pos, c in caches.items():
        out[pos] = {}
        for name, t in c.items():
            if name in ("k", "v"):
                z = t.new_zeros(t.shape[:2] + (extra,) + t.shape[3:])
                t = torch.cat([t, z], dim=2)
            out[pos][name] = t
    return out


def run(cfg, batch: int = 4, prompt_len: int = 16, gen_len: int = 16,
        seed: int = 0, device=None, model=None, prompts=None) -> dict:
    """Prefill `batch` prompts of `prompt_len`, then greedy-decode until
    `gen_len` tokens per sequence (the first from the prefill's logits).

    `model` defaults to `cfg`'s weights drawn from `seed` on the device;
    `prompts` to tokens (or, for input_mode="embeddings", bfloat16
    embeddings) drawn from the same generator.  Embedding models are fed
    one fixed random embedding at every decode step, as the reference's
    `main` does.  Returns {"tokens": (B, gen_len) int64 on the CPU,
    "prefill_s", "step_ms": [per decode step], "decode_s"}.
    """
    dev = resolve_device(device if model is None else model.device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if model is None:
        model = transformer.Transformer(
            cfg, transformer.init_params(gen, cfg), device=dev)
    B, P, G = batch, prompt_len, gen_len
    embeds = cfg.input_mode != "tokens"
    if prompts is None:
        if embeds:
            prompts = layers.normal(gen, (B, P, cfg.d_model), 1.0,
                                    torch.bfloat16)
        else:
            prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                                    device=dev)
    prompts = prompts.to(dev)
    step_embed = (layers.normal(gen, (B, 1, cfg.d_model), 1.0,
                                torch.bfloat16) if embeds else None)

    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = engine.prefill_step(model, prompts)
    caches = pad_caches(caches, G)
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    lens = torch.full((B,), P, dtype=torch.int64, device=dev)
    generated = [engine.greedy_sample(logits)[:, None]]
    step_ms = []
    for _ in range(G - 1):
        t1 = time.perf_counter()
        step_in = step_embed if embeds else generated[-1]
        lg, caches = engine.decode_step(model, caches, step_in, lens)
        lens = lens + 1
        generated.append(engine.greedy_sample(lg)[:, None])
        _sync(dev)
        step_ms.append((time.perf_counter() - t1) * 1e3)
    return dict(tokens=torch.cat(generated, dim=1).cpu(), prefill_s=prefill_s,
                step_ms=step_ms, decode_s=sum(step_ms) / 1e3)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: the card (raises without one); cpu")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    B, P, G = args.batch, args.prompt_len, args.gen_len
    r = run(cfg, B, P, G, seed=args.seed, device=args.device)
    print(f"prefill {B}x{P}: {r['prefill_s']:.2f}s")
    print(f"decode {G - 1} steps x {B} seqs: {r['decode_s']:.2f}s "
          f"({(G - 1) * B / max(r['decode_s'], 1e-9):.1f} tok/s)")
    print("sample tokens:", r["tokens"][0][:10].tolist())


if __name__ == "__main__":
    main()
