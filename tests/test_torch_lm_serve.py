"""The port's LM serving surface against the reference on the CPU:
`BatchedServer` token streams (dense, RWKV and the Mamba hybrid, through
the reference's cross-slot prefill), `launch.serve.run` against the
reference's `launch.serve.main()`, `.npz` checkpoints both ways (float32 and
bfloat16), bit-exact bfloat16 weights through `from_reference_params`,
and the LM entry points' refusal to run without a card unless asked.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from test_torch_harness import SRC, reference_lm

from repro_torch.checkpoint import io
from repro_torch.configs import base
from repro_torch.launch import serve
from repro_torch.serve import engine


@pytest.fixture(scope="module")
def ref():
    return reference_lm()


def _pair(ref, arch, dtype="float32"):
    rc = dataclasses.replace(ref.configs.get_arch(arch).reduced(), dtype=dtype)
    pc = dataclasses.replace(base.get_arch(arch).reduced(), dtype=dtype)
    params = ref.transformer.init_params(ref.jax.random.PRNGKey(0), rc)
    model = io.from_reference_params(
        ref.jax.tree_util.tree_map(np.asarray, params), pc, device="cpu")
    return rc, pc, params, model


def _drive(server, prompts):
    """One scripted session: add, step, add while active, step, finish,
    add into the freed slot, step.  Returns every step's answer and every
    finished stream."""
    log = []
    a = server.add_request(prompts[0])
    log += [server.step() for _ in range(3)]
    b = server.add_request(prompts[1])
    log += [server.step() for _ in range(4)]
    log.append(server.finish(a))
    c = server.add_request(prompts[2])
    log += [server.step() for _ in range(3)]
    log += [server.finish(b), server.finish(c), (a, b, c)]
    return log


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-7b",
                                  "jamba-1.5-large-398b"])
def test_batched_server_streams_equal_reference(ref, arch):
    rc, pc, params, model = _pair(ref, arch)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, rc.vocab_size, n).tolist() for n in (5, 4, 6)]
    want = _drive(ref.engine.BatchedServer(rc, params, max_seq=32, batch=3),
                  prompts)
    got = _drive(engine.BatchedServer(model, max_seq=32, batch=3), prompts)
    assert got == want


def test_batched_server_prefill_advances_other_slots_recurrent_state(ref):
    """The reference's add_request decodes the whole batch with token 0 in
    every other slot: an active RWKV slot's state moves (as there)."""
    _, _, _, model = _pair(ref, "rwkv6-7b")
    srv = engine.BatchedServer(model, max_seq=16, batch=2)
    srv.add_request([5, 6])
    srv.step()
    before = srv.caches["pos0"]["S"][:, 0].clone()
    srv.add_request([7])
    assert not torch.equal(before, srv.caches["pos0"]["S"][:, 0])


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-7b",
                                  "jamba-1.5-large-398b"])
def test_launch_serve_run_equals_reference_main(ref, arch, capsys,
                                                monkeypatch):
    """The reference's `launch.serve.main()` (PRNGKey(0) weights and prompts,
    B=4, P=16, G=16) against `run` on the same weights and prompts: every
    generated token, and the sample line it prints."""
    jax, jnp = ref.jax, ref.jnp
    rc, pc, params, model = _pair(ref, arch)
    B, P, G = 4, 16, 16
    key = jax.random.PRNGKey(0)
    prompts = np.asarray(jax.random.randint(key, (B, P), 0, rc.vocab_size))
    got = serve.run(pc, B, P, G, model=model,
                    prompts=torch.from_numpy(prompts.astype(np.int64)))
    assert got["tokens"].shape == (B, G) and len(got["step_ms"]) == G - 1

    # the reference's serving loop, on its own weights and prompts
    logits, caches = ref.engine.prefill_step(params, jnp.asarray(prompts), rc)
    caches = jax.tree_util.tree_map(
        lambda c: jnp.concatenate(
            [c, jnp.zeros(c.shape[:2] + (G,) + c.shape[3:], c.dtype)], axis=2)
        if c.ndim >= 4 and c.shape[2] == P else c, caches)
    decode = jax.jit(
        lambda p, c, t, n: ref.transformer.decode_step(p, c, t, n, rc))
    lens = jnp.full((B,), P, jnp.int32)
    generated = [jnp.argmax(logits[:, -1], -1)[:, None]]
    for _ in range(G - 1):
        lg, caches = decode(params, caches, generated[-1], lens)
        lens = lens + 1
        generated.append(jnp.argmax(lg[:, -1], -1)[:, None])
    want = np.asarray(jnp.concatenate(generated, axis=1))
    np.testing.assert_array_equal(got["tokens"].numpy(), want)

    monkeypatch.setattr(sys, "argv", ["serve", "--arch", arch, "--smoke"])
    ref.launch_serve.main()
    line = [s for s in capsys.readouterr().out.splitlines()
            if s.startswith("sample tokens:")][0]
    assert line == f"sample tokens: {want[0][:10].tolist()}"


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "jamba-1.5-large-398b"])
def test_reference_checkpoint_restores_in_port_and_back(ref, arch, tmp_path):
    rc, pc, params, _ = _pair(ref, arch)
    path = str(tmp_path / "ref.npz")
    ref.io.save(path, params)
    model = io.restore(path, pc, device="cpu")
    x = np.random.default_rng(0).integers(0, rc.vocab_size, (2, 9))
    want, _, _ = ref.transformer.forward(
        params, ref.jnp.asarray(x.astype(np.int32)), rc)
    got, _, _ = model.forward(torch.from_numpy(x))
    np.testing.assert_allclose(np.asarray(want), got.numpy(), atol=1e-4,
                               rtol=1e-4)
    back = str(tmp_path / "port.npz")
    io.save(back, model)
    again = ref.io.restore(back, params)
    for (pa, a), (_, b) in zip(
            ref.jax.tree_util.tree_flatten_with_path(params)[0],
            ref.jax.tree_util.tree_flatten_with_path(again)[0]):
        assert a.dtype == b.dtype, pa
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_bf16_reference_params_convert_bit_for_bit(ref, tmp_path):
    """bfloat16 leaves from JAX (numpy's extension dtype), from a
    reference-written `.npz` (raw 2-byte records) and back through the
    port's `save` (float32, which the reference restores exactly)."""
    rc, pc, params, model = _pair(ref, "olmoe-1b-7b", dtype="bfloat16")
    flat = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in
            ref.jax.tree_util.tree_flatten_with_path(params)[0]}
    assert any(a.dtype.name == "bfloat16" for a in flat.values())
    got = {n.replace(".", "/"): t for n, t in model.params.named_parameters()}

    def same_bits(a, t):
        if a.dtype.name == "bfloat16" or a.dtype.kind == "V":
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                a.view(np.uint16), t.view(torch.int16).numpy().view(np.uint16))
        else:
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(a, t.numpy())

    for k, a in flat.items():
        same_bits(a, got[k])
    path = str(tmp_path / "ref_bf16.npz")
    ref.io.save(path, params)
    restored = io.restore(path, pc, device="cpu")
    with np.load(path) as data:
        assert any(data[k].dtype.kind == "V" for k in data.files)
        for n, t in restored.params.named_parameters():
            same_bits(data[n.replace(".", "/")], t)
    back = str(tmp_path / "port_bf16.npz")
    io.save(back, restored)
    again = ref.io.restore(back, params)
    for a, b in zip(ref.jax.tree_util.tree_leaves(params),
                    ref.jax.tree_util.tree_leaves(again)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a).view(np.uint8),
                                      np.asarray(b).view(np.uint8))


def test_restore_refuses_a_mismatched_tree(ref, tmp_path):
    _, _, params, _ = _pair(ref, "qwen3-0.6b")
    path = str(tmp_path / "ref.npz")
    ref.io.save(path, params)
    with pytest.raises(ValueError, match="missing"):
        io.restore(path, base.get_arch("rwkv6-7b").reduced(), device="cpu")
    wide = dataclasses.replace(base.get_arch("qwen3-0.6b").reduced(),
                               d_ff=1024)
    with pytest.raises(ValueError, match="shape"):
        io.restore(path, wide, device="cpu")


@pytest.mark.parametrize("entry", [
    "Transformer(cfg, init_params(torch.Generator().manual_seed(0), cfg))",
    "init_cache(cfg, 2, 8)",
    "serve.run(cfg, 2, 4, 2)",
    "serve.main(['--smoke'])",
])
def test_lm_entry_points_raise_without_cuda(entry):
    """Each LM entry point runs on the card by default and raises when
    there is none, before any work; device="cpu" is the only way here."""
    code = textwrap.dedent(f"""
        import torch
        from repro_torch.configs.base import get_arch
        from repro_torch.launch import serve
        from repro_torch.models.transformer import (Transformer, init_cache,
                                                    init_params)
        cfg = get_arch("qwen3-0.6b").reduced()
        try:
            {entry}
        except RuntimeError as e:
            assert "CUDA" in str(e), e
            print("raised")
        else:
            raise SystemExit("ran without a GPU")
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=str(SRC),
                                CUDA_VISIBLE_DEVICES=""))
    assert r.returncode == 0, r.stderr
    assert "raised" in r.stdout
