"""The port's LM training pieces against the reference on the CPU:
`TokenStream` batches bit for bit, the AdamW schedule and update, the
chunked cross-entropy (value and gradients), remat, the loss falling on
the token stream, train-state checkpoints both ways, the
`launch.train` entry point, and its refusal to run without a card unless
asked.  (The per-architecture train steps are in
`test_torch_lm_train_archs.py`.)
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
from repro_torch.data.synthetic import TokenStream
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer
from repro_torch.optim import adamw
from repro_torch.train import step as tstep


@pytest.fixture(scope="module")
def ref():
    return reference_lm()


def _tensor_tree(tree):
    """A JAX tree as torch tensors, bit for bit (bfloat16 included)."""
    if isinstance(tree, dict):
        return {k: _tensor_tree(v) for k, v in tree.items()}
    return io._to_tensor(np.asarray(tree))


@pytest.mark.parametrize("vocab,seq,batch,seed", [(128, 32, 8, 1),
                                                  (151_936, 17, 3, 0)])
def test_token_stream_equals_reference(ref, vocab, seq, batch, seed):
    mine = TokenStream(vocab, seq, batch, seed)
    theirs = ref.synthetic.TokenStream(vocab, seq, batch, seed)
    for _ in range(3):
        a, b = next(mine), next(theirs)
        for k in ("inputs", "labels"):
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(a["inputs"][:, 1:], a["labels"][:, :-1])


def test_schedule_equals_reference(ref):
    """Warmup, peak, cosine and floor, the reference's test points; the
    float32 values bit for bit."""
    cfg = dict(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    got = [float(adamw.schedule(adamw.AdamWConfig(**cfg), s))
           for s in (0, 5, 10, 50, 100)]
    want = [float(ref.adamw.schedule(ref.adamw.AdamWConfig(**cfg), s))
            for s in (0, 5, 10, 50, 100)]
    assert got == want
    assert got[0] == 0 and got[1] == pytest.approx(5e-4)
    assert got[2] == pytest.approx(1e-3) and got[3] < got[2]
    assert got[4] == pytest.approx(1e-4, rel=1e-2)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
def test_apply_updates_equals_reference(ref, pdtype, moments):
    """One update from equal inputs at step 5 (warmup over, nonzero
    moments).  Float32 leaves within rtol 1e-6 plus atol 1e-6 of the
    leaf's largest magnitude (a few ulp over the update's chain of
    roundings: the reference's CPU compiler contracts `b·m + (1 − b)·g`
    into a fused multiply-add, the port rounds the product first, and
    where the two terms cancel the difference is an ulp of the terms,
    not of the result); bfloat16 leaves within one bfloat16 ulp, where a
    1-ulp float32 difference flips the final rounding."""
    jax, jnp = ref.jax, ref.jnp
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
    rng = np.random.default_rng(0)
    shapes = {"a": (64, 33), "b": {"c": (7,)}}

    def draw(scale, dt, positive=False):
        def one(shape):
            x = rng.random(shape) if positive else rng.normal(size=shape)
            return jnp.asarray((x * scale).astype(np.float32), jdt[dt])
        return {"a": one(shapes["a"]), "b": {"c": one(shapes["b"]["c"])}}

    p, g = draw(1.0, pdtype), draw(1e-2, pdtype)
    st = {"mu": draw(1e-3, moments), "nu": draw(1e-4, moments, True),
          "step": jnp.asarray(5, jnp.int32)}
    kw = dict(lr=1e-2, warmup_steps=3, total_steps=50, moments_dtype=moments)
    rp, ro = jax.jit(lambda a, b, c: ref.adamw.apply_updates(
        a, b, c, ref.adamw.AdamWConfig(**kw)))(p, g, st)

    tp, tg = _tensor_tree(p), _tensor_tree(g)
    tst = {"mu": _tensor_tree(st["mu"]), "nu": _tensor_tree(st["nu"]),
           "step": torch.tensor(5, dtype=torch.int32)}
    newp, opt = adamw.apply_updates(tp, tg, tst, adamw.AdamWConfig(**kw))
    assert newp is tp and int(opt["step"]) == 6
    for want, got in ((rp, newp), (ro["mu"], opt["mu"]),
                      (ro["nu"], opt["nu"])):
        for w, t in zip(jax.tree_util.tree_leaves(want),
                        list(adamw.leaves(got))):
            assert t.dtype == (torch.bfloat16 if w.dtype == jnp.bfloat16
                               else torch.float32)
            w = np.asarray(w).astype(np.float32)
            t = t.float().numpy()
            if np.asarray(want["a"]).dtype == jnp.bfloat16:
                np.testing.assert_allclose(t, w, rtol=2 ** -7, atol=0)
            else:
                np.testing.assert_allclose(t, w, rtol=1e-6,
                                           atol=1e-6 * np.abs(w).max())


def test_init_state_moments_dtype():
    p = {"w": torch.ones(3, 2, dtype=torch.bfloat16)}
    for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        st = adamw.init_state(p, adamw.AdamWConfig(moments_dtype=name))
        assert st["mu"]["w"].dtype == st["nu"]["w"].dtype == dt
        assert st["step"].dtype == torch.int32 and int(st["step"]) == 0


@pytest.mark.parametrize("S,num_chunks", [(32, 1), (32, 2), (32, 8),
                                          (24, 16)])
def test_chunked_ce_matches_reference_and_full(ref, S, num_chunks):
    """Value and gradients (x, lm_head) against the reference's chunked CE
    and the port's full CE; S = 24 with 16 chunks halves to 8 chunks of 3.
    Float32, rtol 1e-5."""
    jax, jnp = ref.jax, ref.jnp
    rng = np.random.default_rng(0)
    B, D, V = 2, 16, 50
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    w = (rng.normal(size=(D, V)) * 0.1).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    rfn = lambda a, b: ref.train_step.chunked_cross_entropy(
        a, b, jnp.asarray(labels), 1e-4, num_chunks)
    rv, (rgx, rgw) = jax.value_and_grad(rfn, argnums=(0, 1))(x, w)

    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    lt = torch.from_numpy(labels.astype(np.int64))
    v = tstep.chunked_cross_entropy(xt, wt, lt, 1e-4, num_chunks)
    gx, gw = torch.autograd.grad(v, (xt, wt))
    v = v.detach()
    np.testing.assert_allclose(float(v), float(rv), rtol=1e-5)
    np.testing.assert_allclose(gx.numpy(), np.asarray(rgx), rtol=1e-5,
                               atol=1e-8)
    np.testing.assert_allclose(gw.numpy(), np.asarray(rgw), rtol=1e-5,
                               atol=1e-8)

    xf = torch.from_numpy(x).requires_grad_(True)
    wf = torch.from_numpy(w).requires_grad_(True)
    full = tstep.cross_entropy(xf @ wf, lt, 1e-4)
    fx, fw = torch.autograd.grad(full, (xf, wf))
    np.testing.assert_allclose(float(v), float(full.detach()), rtol=1e-5)
    np.testing.assert_allclose(gx.numpy(), fx.numpy(), rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(gw.numpy(), fw.numpy(), rtol=1e-5, atol=1e-8)
    want_full = ref.train_step.cross_entropy(
        jnp.einsum("bsd,dv->bsv", x, w), jnp.asarray(labels), 1e-4)
    np.testing.assert_allclose(float(full.detach()), float(want_full),
                               rtol=1e-5)


def test_chunked_ce_bfloat16_matches_reference(ref):
    """bfloat16 x and lm_head: each chunk's logits are the model-dtype
    product cast to float32, as the reference's.  rtol 1e-3 (bfloat16
    products summed in another order)."""
    jax, jnp = ref.jax, ref.jnp
    rng = np.random.default_rng(1)
    B, S, D, V = 2, 16, 32, 64
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    w = (rng.normal(size=(D, V)) * 0.1).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    want = ref.train_step.chunked_cross_entropy(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
        jnp.asarray(labels), 1e-4, 4)
    got = tstep.chunked_cross_entropy(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(),
        torch.from_numpy(labels.astype(np.int64)), 1e-4, 4)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-3)


@pytest.fixture
def deterministic():
    """torch's deterministic algorithms for one test.  On the CPU the
    embedding gather's backward (`index_put_` with accumulate) otherwise
    adds repeated rows from several threads in a racing order; on CUDA it
    is a sorted segment sum either way."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "olmoe-1b-7b",
                                  "jamba-1.5-large-398b", "rwkv6-7b"])
def test_remat_modes_give_equal_losses_and_grads(arch, monkeypatch,
                                                 deterministic):
    """none, full and dots recompute the same ops in the same order, so
    the loss and every gradient are bit-equal; `dots` keeps the outputs of
    the unbatched products (its policy is consulted and saves `mm`), and
    `full` keeps none."""
    cfg = base.get_arch(arch).reduced()
    rng = np.random.default_rng(1)
    batch = {"inputs": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (2, 16))),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (2, 16)))}
    saved = []
    policy = transformer._save_matmuls

    def counting(ctx, op, *a, **k):
        out = policy(ctx, op, *a, **k)
        saved.append(out == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE)
        return out

    monkeypatch.setattr(transformer, "_save_matmuls", counting)
    out = {}
    for remat in ("none", "full", "dots"):
        tcfg = tstep.TrainConfig(remat=remat)
        st = tstep.init_train_state(0, cfg, tcfg, device="cpu")
        n = len(saved)
        total, _ = tstep.make_loss_fn(cfg, tcfg)(st["model"], batch)
        total.backward()
        out[remat] = (total.detach(), {
            k: p.grad for k, p in st["model"].params.named_parameters()})
        assert (sum(saved[n:]) > 0) == (remat == "dots"), remat
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0]), remat
        for k, g in out["none"][1].items():
            assert torch.equal(out[remat][1][k], g), (remat, k)
    with pytest.raises(ValueError, match="remat"):
        tstep.init_train_state(0, cfg, tstep.TrainConfig(), "cpu")[
            "model"].forward_hidden(batch["inputs"], remat="some")


def test_serving_keeps_gradients_off_and_training_turns_them_on():
    cfg = base.get_arch("qwen3-0.6b").reduced()
    model = transformer.Transformer(
        cfg, transformer.init_params(torch.Generator().manual_seed(0), cfg),
        device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    state = tstep.train_state(model, tstep.TrainConfig())
    assert all(p.requires_grad for p in state["model"].parameters())
    # block views from one unbind per stack are the stacks' slices
    stacks = model.params["blocks"]["pos0"]["mixer"]
    for b, bp in enumerate(model.params["blocks"].unbind()):
        for k, t in bp["pos0"]["mixer"].items():
            assert torch.equal(t, stacks[k][b]), (b, k)


def test_loss_decreases_quick():
    """The reference's `test_loss_decreases_quick`, on the port."""
    cfg = dataclasses.replace(base.get_arch("qwen3-0.6b").reduced(),
                              num_layers=2, d_model=128, d_ff=256,
                              vocab_size=128, head_dim=32)
    tcfg = tstep.TrainConfig(
        optimizer=adamw.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=60),
        ce_chunks=2)
    state = tstep.init_train_state(0, cfg, tcfg, device="cpu")
    step = tstep.make_train_step(cfg, tcfg)
    stream = TokenStream(cfg.vocab_size, 32, 8, seed=1)
    losses = []
    for _, raw in zip(range(60), stream):
        state, m = step(state, launch_train.to_batch(raw, "cpu"))
        losses.append(float(m["ce"]))
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.2, losses[::10]


def _ref_state(ref, rc, rt, steps=1):
    """The reference's state after `steps` steps on TokenStream batches."""
    jax, jnp = ref.jax, ref.jnp
    state = jax.jit(ref.train_step.init_train_state, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), rc, rt)
    step = jax.jit(ref.train_step.make_train_step(rc, rt))
    for _, raw in zip(range(steps), TokenStream(rc.vocab_size, 8, 2, 0)):
        state, _ = step(state, {k: jnp.asarray(v) for k, v in raw.items()})
    return state


@pytest.mark.parametrize("dtype,moments", [("float32", "float32"),
                                           ("bfloat16", "bfloat16")])
def test_train_state_checkpoints_cross_both_ways(ref, tmp_path, dtype,
                                                 moments):
    """A state the port wrote (after one step, so the moments are not
    zero) restores in the reference's `restore(path, like)` with the
    reference's keys and equal bits (bfloat16 leaves are written as
    float32, exactly); a float32 state the reference wrote restores in
    the port bit for bit, and the port's next step from it matches the
    reference's."""
    jax, jnp = ref.jax, ref.jnp
    rc = dataclasses.replace(ref.configs.get_arch("olmoe-1b-7b").reduced(),
                             dtype=dtype)
    pc = dataclasses.replace(base.get_arch("olmoe-1b-7b").reduced(),
                             dtype=dtype)
    rt = ref.train_step.TrainConfig(ce_chunks=2, optimizer=ref.adamw
                                    .AdamWConfig(moments_dtype=moments))
    pt = tstep.TrainConfig(ce_chunks=2, optimizer=adamw.AdamWConfig(
        moments_dtype=moments))
    state = tstep.init_train_state(0, pc, pt, device="cpu")
    raw = next(TokenStream(pc.vocab_size, 8, 2, 0))
    state, _ = tstep.make_train_step(pc, pt)(state,
                                             launch_train.to_batch(raw, "cpu"))
    path = str(tmp_path / "port_state.npz")
    io.save_state(path, state)
    like = jax.tree_util.tree_map(
        jnp.zeros_like, jax.eval_shape(
            lambda k: ref.train_step.init_train_state(k, rc, rt),
            jax.random.PRNGKey(0)))
    restored = ref.io.restore(path, like)
    mine = io.flatten_state(state)
    with np.load(path) as data:
        assert set(data.files) == set(mine) == set(
            io._flatten(jax.tree_util.tree_map(np.asarray, restored)))
    for key, leaf in io._flatten(jax.tree_util.tree_map(
            lambda a: a, restored)).items():
        t = mine[key]
        assert np.asarray(leaf).dtype == np.asarray(
            io._flatten(like)[key]).dtype
        got = io._to_tensor(np.asarray(leaf))
        assert got.dtype == t.dtype, key
        assert torch.equal(got, t.cpu()), key

    if dtype != "float32":
        return
    rstate = _ref_state(ref, rc, rt)
    rpath = str(tmp_path / "ref_state.npz")
    ref.io.save(rpath, rstate)
    back = io.restore_state(rpath, pc, pt, device="cpu")
    want = io._flatten(jax.tree_util.tree_map(np.asarray, rstate))
    got = io.flatten_state(back)
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    assert int(back["opt"]["step"]) == int(want["opt/step"]) == 1
    assert all(p.requires_grad for p in back["model"].parameters())
    raw = next(TokenStream(pc.vocab_size, 8, 2, 5))
    _, rm = ref.train_step.make_train_step(rc, rt)(
        rstate, {k: jnp.asarray(v) for k, v in raw.items()})
    _, pm = tstep.make_train_step(pc, pt)(back,
                                          launch_train.to_batch(raw, "cpu"))
    for k in rm:
        np.testing.assert_allclose(float(pm[k]), float(rm[k]), rtol=1e-4)


def test_restore_state_refuses_a_mismatched_tree(ref, tmp_path):
    rc = ref.configs.get_arch("qwen3-0.6b").reduced()
    rt = ref.train_step.TrainConfig()
    jax = ref.jax
    flat = io._flatten(jax.tree_util.tree_map(np.asarray, jax.jit(
        ref.train_step.init_train_state, static_argnums=(1, 2))(
            jax.random.PRNGKey(0), rc, rt)))
    pc = base.get_arch("qwen3-0.6b").reduced()
    del flat["opt/nu/lm_head"]
    with pytest.raises(ValueError, match="missing"):
        io.from_reference_state(flat, pc, tstep.TrainConfig(), device="cpu")


def test_launch_train_main_runs_on_the_cpu(ref, tmp_path, capsys,
                                           monkeypatch):
    """`python -m repro_torch.launch.train --smoke --device cpu` trains a
    few steps and prints the reference's lines: the header equal to the
    reference's `main` on the same flags (the parameter count), then the
    step lines, the checkpoint line and the `ce first10/last10` line."""
    path = str(tmp_path / "state.npz")
    flags = ["--arch", "qwen3-0.6b", "--smoke", "--steps", "3", "--batch",
             "2", "--seq", "16", "--checkpoint", path]
    launch_train.main(flags + ["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["train"] + flags[:-2])
    ref.launch_train.main()
    want = capsys.readouterr().out.splitlines()
    assert out[0] == want[0] == (
        "arch=qwen3-0.6b-smoke params=1.6M steps=3 batch=2 seq=16")
    steps = [s for s in out if s.startswith("step ")]
    assert [s.split()[1] for s in steps] == ["0", "2"]    # every 10th, last
    assert [s.split()[1] for s in want if s.startswith("step ")] == \
        ["0", "2"]
    assert out[-2] == f"checkpoint -> {path}"
    assert out[-1].startswith("ce first10=") and want[-1].startswith(
        "ce first10=")
    state = io.restore_state(path, base.get_arch("qwen3-0.6b").reduced(),
                             tstep.TrainConfig(), device="cpu")
    assert int(state["opt"]["step"]) == 3


def test_train_loop_raises_without_cuda():
    """`train_loop` with device=None runs on the card, and raises before
    any work when there is none."""
    code = textwrap.dedent("""
        from repro_torch.configs.base import get_arch
        from repro_torch.launch.train import train_loop
        try:
            train_loop(get_arch("qwen3-0.6b").reduced(), steps=2, batch=2,
                       seq=8)
        except RuntimeError as e:
            assert "CUDA" in str(e), e
            print("raised")
        else:
            raise SystemExit("trained without a GPU")
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=str(SRC),
                                CUDA_VISIBLE_DEVICES=""))
    assert r.returncode == 0, r.stderr
    assert "raised" in r.stdout
