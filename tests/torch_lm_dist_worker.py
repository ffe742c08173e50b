"""Processes behind `test_torch_lm_sharded.py` (not a test module).

    python tests/torch_lm_dist_worker.py reference OUT
    python tests/torch_lm_dist_worker.py port RANK WORLD STORE OUT

`reference` (run with XLA_FLAGS=--xla_force_host_platform_device_count=4):
for each arch of `ARCHS`, the reduced model's initial train state
(`init_train_state(PRNGKey(SEED))`, as the reference's `train_loop`
draws it) into `OUT/<arch>.init.npz`, and the reference's
`train_loop(mesh=make_host_mesh(2, 2))` run for 1 and for 2 steps, its
train-state checkpoints into `OUT/<arch>.ref{1,2}.npz` and its ce
values into `OUT/<arch>.json`.  The 1-step run is the first step of the
2-step run: warmup is one step either way and the cosine schedule is at
its start.

`port`: one rank of a gloo group of WORLD = 4 processes on the CPU, a
("data", "model") = (2, 2) `DeviceMesh` (`launch.mesh.make_host_mesh`).
It waits for the reference's initial states, then runs the port's
`train_loop(mesh=...)` from them for 1 and 2 steps (checkpoints
`OUT/<arch>.port{1,2}.npz`, written once by rank 0), the one-device
`train_loop` for 1 step of the dense arch (`OUT/<arch>.one1.npz`),
checks that the sharded checkpoint restores bit for bit into a
one-device state, and decodes 4 tokens with the reduced dense model on
the mesh under `DECODE_OVERRIDES` and on one device
(`OUT/decode.npz`).  Rank 0 writes `OUT/port.json`.
"""
import json
import sys
import time
from pathlib import Path

import numpy as np

ARCHS = ("qwen3-0.6b", "olmoe-1b-7b")
DENSE = "qwen3-0.6b"
SEED, BATCH, SEQ, LR = 0, 4, 16, 1e-4
DECODE_B, DECODE_LEN, DECODE_STEPS = 4, 8, 4


def reference(out):
    import jax
    from repro.checkpoint import io
    from repro.configs.base import get_arch
    from repro.launch import train as launch_train
    from repro.launch.mesh import make_host_mesh
    from repro.optim import adamw
    from repro.train import step as train_step

    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    mesh = make_host_mesh(2, 2)
    for arch in ARCHS:
        cfg = get_arch(arch).reduced()
        tcfg = train_step.TrainConfig(
            optimizer=adamw.AdamWConfig(lr=LR, warmup_steps=1,
                                        total_steps=2), ce_chunks=4)
        state = jax.jit(train_step.init_train_state, static_argnums=(1, 2))(
            jax.random.PRNGKey(SEED), cfg, tcfg)
        io.save(str(out / f"{arch}.init.npz"), state)
        ces = {}
        for steps in (1, 2):
            _, losses = launch_train.train_loop(
                cfg, steps=steps, batch=BATCH, seq=SEQ, lr=LR, seed=SEED,
                mesh=mesh, checkpoint_path=str(out / f"{arch}.ref{steps}.npz"))
            ces[steps] = [float(c) for c in losses]
        (out / f"{arch}.json").write_text(json.dumps(ces))
    (out / "done").write_text("ok")


def _wait_for(path: Path, timeout=600):
    t0 = time.time()
    while not path.exists():
        if time.time() - t0 > timeout:
            raise TimeoutError(f"no {path}")
        time.sleep(0.5)


def port(rank, world, store, out):
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import io
    from repro_torch.configs.base import get_arch
    from repro_torch.launch import specs
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    from repro_torch.train import sharding as shd
    from repro_torch.train import step as train_step

    torch.set_num_threads(1)        # one thread a rank: four share the cores
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    out = Path(out)
    res = {}
    mesh = make_host_mesh(2, 2, device_type="cpu")
    _wait_for(out / "done")
    for arch in ARCHS:
        cfg = get_arch(arch).reduced()
        tcfg = train_step.TrainConfig(
            optimizer=adamw.AdamWConfig(lr=LR, warmup_steps=1,
                                        total_steps=2), ce_chunks=4)

        def init():
            return io.restore_state(str(out / f"{arch}.init.npz"), cfg, tcfg,
                                    device="cpu")

        ces = {}
        for steps in (1, 2):
            path = str(out / f"{arch}.port{steps}.npz")
            st, losses = launch_train.train_loop(
                cfg, steps=steps, batch=BATCH, seq=SEQ, lr=LR, seed=SEED,
                mesh=mesh, state=init(), checkpoint_path=path)
            ces[steps] = losses
        # the checkpoint of the sharded state restores bit for bit
        full = io.flatten_state(train_step.unshard_state(st))
        dist.barrier()
        if rank == 0:
            back = io.flatten_state(io.restore_state(path, cfg, tcfg,
                                                     device="cpu"))
            res[f"{arch}.restore_bits"] = sorted(full) == sorted(back) and all(
                torch.equal(full[k].cpu(), back[k]) for k in full)
            if arch == DENSE:
                _, one = launch_train.train_loop(
                    cfg, steps=1, batch=BATCH, seq=SEQ, lr=LR, seed=SEED,
                    state=init(), device="cpu",
                    checkpoint_path=str(out / f"{arch}.one1.npz"))
                ces["one1"] = one
        res[f"{arch}.ce"] = ces

    # decode: the reduced dense model, 4 tokens, on the mesh and on one device
    cfg = get_arch(DENSE).reduced()
    params = transformer.init_params(torch.Generator().manual_seed(SEED), cfg)
    one = transformer.Transformer(cfg, params, device="cpu")
    rules = shd.make_rules(mesh, shd.DECODE_OVERRIDES)
    sharded = transformer.Transformer(cfg, shd.distribute_tree(
        params, shd.tree_param_specs(params, mesh, rules), mesh),
        device="cpu")
    pls = specs.cache_placements(cfg, DECODE_B, DECODE_LEN, mesh, rules)
    c_one = transformer.init_cache(cfg, DECODE_B, DECODE_LEN, device="cpu")
    c_mesh = {p: {n: shd.distribute(t.clone(), mesh, pls[p][n])
                  for n, t in c.items()} for p, c in c_one.items()}
    tok_pl = shd.placements(shd.logical_spec(("batch", None), mesh, rules),
                            mesh)
    len_pl = shd.placements(shd.logical_spec(("batch",), mesh, rules), mesh)
    gen = torch.Generator().manual_seed(3)
    want, got = [], []
    with torch.no_grad():
        for i in range(DECODE_STEPS):
            tok = torch.randint(0, cfg.vocab_size, (DECODE_B, 1),
                                generator=gen)
            clen = torch.full((DECODE_B,), i, dtype=torch.int64)
            lo, c_one = one.decode_step(c_one, tok, clen)
            with shd.use_mesh_rules(mesh, shd.DECODE_OVERRIDES):
                lm, c_mesh = sharded.decode_step(
                    c_mesh, shd.distribute(tok, mesh, tok_pl),
                    shd.distribute(clen, mesh, len_pl))
            want.append(lo.numpy())
            got.append(lm.full_tensor().numpy())
    res["decode_cache_placements"] = str(c_mesh["pos0"]["k"].placements)
    if rank == 0:
        np.savez(out / "decode.npz", one=np.stack(want), mesh=np.stack(got))
        (out / "port.json").write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1] == "port":
        port(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    else:
        reference(sys.argv[2])
