"""Processes behind `test_torch_distributed.py` (not a test module).

    python tests/torch_dist_worker.py port RANK WORLD STORE OUT
    python tests/torch_dist_worker.py reference OUT

`port`: one rank of a gloo group of WORLD processes on the CPU, meeting
through the FileStore STORE.  On a (data=2, model=2) mesh it fits every
forest of `FORESTS` locally and through the port's mesh engines, the
streamed and GBT fits, the condition broadcast, the shape errors, and the
engines' outputs on `engine_inputs()`; it writes `OUT.json` (digests,
checks) and, rank 0 only, `OUT.npz` (tree and engine arrays).

`reference`: the reference's local forests of `FORESTS` and its mesh
engines on the same engine inputs, on a forced 2x2 host mesh (run with
`XLA_FLAGS=--xla_force_host_platform_device_count=4`), into `OUT.npz`.

Both sides make their inputs here, from numpy seeds.
"""
import hashlib
import json
import sys
from pathlib import Path

import numpy as np

N_ROWS = 1024
TREES, SEED = 3, 7
TREE_KEYS = ("feature", "threshold", "is_cat", "cat_mask", "children",
             "value", "depth", "n_node")

_EXACT = dict(max_depth=4)
_HIST = dict(max_depth=4, split_mode="hist", num_bins=32)
_REG = dict(task="regression", impurity="variance", min_records=10)
# name -> (TreeParams, data, numeric engine, categorical engine)
FORESTS = {
    "exact_2d": (_EXACT, "mixed", "exact_2d", "categorical"),
    "exact_2d_scan": (_EXACT, "mixed", "exact_2d_scan", None),
    "exact_columns": (_EXACT, "mixed", "exact_columns", None),
    "categorical": (_EXACT, "mixed", None, "categorical"),
    "hist_subtract": (_HIST, "mixed", "hist", "categorical"),
    "hist_plain": (dict(_HIST, hist_subtract=False), "mixed", "hist", None),
    "pruned": (dict(max_depth=5, min_records=60, prune_closed_frac=0.3),
               "mixed", "exact_2d", "categorical"),
    "regression_hist": (dict(_HIST, **_REG), "regression", "hist",
                        "categorical"),
    "regression_exact": (dict(_EXACT, **_REG), "regression", "exact_2d",
                         "categorical"),
}
# the pruned forest's point of comparison: the same fit without pruning.
# Its trees train one at a time, so that rows closed in its one tree are
# dropped (a batch drops only rows closed in every tree)
UNPRUNED = dict(max_depth=5, min_records=60)
STREAM_CHUNK = 300


def make_data(n=N_ROWS, seed=1):
    """8 numeric (one heavily tied) + 4 categorical columns of arity 5;
    binary labels with 10% noise and a regression target."""
    rng = np.random.default_rng(seed)
    num = rng.normal(size=(n, 8)).astype(np.float32)
    num[:, 1] = np.round(num[:, 1], 1)
    cat = rng.integers(0, 5, size=(n, 4)).astype(np.int32)
    y = ((num[:, 0] > 0) ^ (cat[:, 0] >= 3)).astype(np.int32)
    y ^= (rng.random(n) < 0.1).astype(np.int32)
    yreg = (2 * num[:, 0] + cat[:, 1] + 0.3 * rng.normal(size=n)).astype(
        np.float32)
    return num, cat, y, yreg


def engine_inputs(seed=0):
    """One level's inputs for the engine-level comparison: 512 rows, 8
    numeric (presorted) and 4 categorical columns, L = 3 open leaves, 2
    classes, integer bag weights, random candidate masks, 32 bins."""
    rng = np.random.default_rng(seed)
    n, m, L, B = 512, 8, 3, 32
    num = np.round(rng.normal(size=(n, m)), 2).astype(np.float32)
    y = rng.integers(0, 2, n).astype(np.int32)
    w = rng.integers(0, 3, n).astype(np.float32)
    leaf = rng.integers(0, L + 1, n).astype(np.int32)
    si = np.argsort(num.T, axis=-1, kind="stable").astype(np.int32)
    sv = np.take_along_axis(num.T, si, -1)
    cand = rng.random((m, L + 1)) < 0.7
    cand[:, 0] = False
    bins = rng.integers(0, B, (m, n)).astype(np.uint8)
    edges = np.sort(rng.normal(size=(m, B)).astype(np.float32), axis=1)
    cat = rng.integers(0, 5, (n, 4)).astype(np.int32)
    leaf2 = rng.integers(0, L + 1, (2, n)).astype(np.int32)
    w2 = rng.integers(0, 3, (2, n)).astype(np.float32)
    cand_cat = rng.random((2, 4, L + 1)) < 0.7
    cand_cat[..., 0] = False
    feat = rng.integers(0, m, L + 1).astype(np.int32)
    thr = rng.normal(size=L + 1).astype(np.float32)
    return dict(num=num, y=y, w=w, leaf=leaf, si=si, sv=sv, cand=cand,
                bins=bins, edges=edges, cat=cat, leaf2=leaf2, w2=w2,
                cand_cat=cand_cat, feat=feat, thr=thr, L=L)


def _tree_arrays(prefix, trees, out):
    for t, tr in enumerate(trees):
        for k in TREE_KEYS:
            out[f"{prefix}/{t}/{k}"] = np.asarray(getattr(tr, k))


def _digest(trees) -> str:
    h = hashlib.sha256()
    for tr in trees:
        for k in TREE_KEYS:
            h.update(np.ascontiguousarray(getattr(tr, k)).tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# The port: one gloo rank
# ---------------------------------------------------------------------------

def port(rank, world, store, out):
    import torch
    import torch.distributed as dist

    from repro_torch.core import distributed as D
    from repro_torch.core import tree as tree_lib
    from repro_torch.core.dataset import ArrayRowSource, from_numpy
    from repro_torch.core.forest import RandomForest
    from repro_torch.core.gbt import GBTModel, GBTParams
    from repro_torch.core.level.engines import LevelInputs, LevelStatics
    from repro_torch.core.level.sharded import ShardedHistNumeric
    from repro_torch.launch.mesh import make_mesh

    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    res, arrays = {"rank": rank}, {}
    try:
        mesh = make_mesh(2, 2, backend="gloo", device="cpu")
        res["mesh"] = dict(shape=mesh.shape, coords=mesh.coords,
                           staged=sorted(mesh.staged))
        # the collectives themselves
        x = torch.full((2, 3), float(rank))
        res["collectives"] = dict(
            gather_data=mesh.all_gather(x, "data")[:, 0, 0].tolist(),
            gather_model=mesh.all_gather(x, "model")[:, 0, 0].tolist(),
            sum_data=mesh.all_reduce(x, "data")[0, 0].item(),
            max_model=mesh.all_reduce(x, "model", "max")[0, 0].item(),
            bools=mesh.all_gather(torch.tensor([rank % 2 == 0]),
                                  "model").tolist(),
            log=[(e["op"], e["axis"], e["bytes"]) for e in mesh.log],
            seconds=[e["seconds"] for e in mesh.log])
        # the host-staged path, forced for every collective
        k = len(mesh.log)
        mesh.staged = frozenset(("all_gather", "all_reduce_sum",
                                 "all_reduce_max"))
        res["staged_collectives"] = dict(
            gather_data=mesh.all_gather(x, "data")[:, 0, 0].tolist(),
            sum_data=mesh.all_reduce(x, "data")[0, 0].item(),
            max_model=mesh.all_reduce(x, "model", "max")[0, 0].item(),
            bools=mesh.all_gather(torch.tensor([rank % 2 == 0]),
                                  "model").tolist(),
            staged=[e["staged"] for e in mesh.log[k:]])
        mesh.staged = frozenset()
        engines = {
            "exact_2d": D.make_2d_sharded_supersplit(mesh),
            "exact_2d_scan": D.make_2d_sharded_supersplit(mesh,
                                                          backend="scan"),
            "exact_columns": D.make_column_sharded_supersplit(mesh),
            "hist": D.make_hist_sharded_supersplit(mesh),
            "categorical": D.make_categorical_sharded_supersplit(mesh),
            None: None}
        num, cat, y, yreg = make_data()
        data = {"mixed": from_numpy(num, cat, y),
                "regression": from_numpy(num, cat, yreg, task="regression")}

        def fit(params, ds, tree_batch=TREES, **kw):
            return RandomForest(tree_lib.TreeParams(**params),
                                num_trees=TREES, seed=SEED,
                                tree_batch=tree_batch, device="cpu").fit(
                ds, collect_stats=True, **kw)

        res["forests"] = {}
        for name, (params, kind, eng, ceng) in FORESTS.items():
            tb = 1 if name == "pruned" else TREES
            local = fit(UNPRUNED if name == "pruned" else params, data[kind],
                        tb)
            sharded = fit(params, data[kind], tb, engine=engines[eng],
                          cat_engine=engines[ceng])
            res["forests"][name] = dict(
                local=_digest(local.trees), sharded=_digest(sharded.trees),
                rows=[[s.rows_scanned // s.feature_passes for s in log]
                      for log in sharded.level_stats])
            _tree_arrays(f"{name}/local", local.trees, arrays)
            _tree_arrays(f"{name}/sharded", sharded.trees, arrays)

        # examples/distributed_forest.py's call, fit(ds, supersplit_fn=sup):
        # the engine taken as the engine, and a bare closure around its
        # legacy signature (per tree), both equal to the local forest
        from repro_torch.data import synthetic
        ex = synthetic.make_tabular("majority", 4000, num_informative=6,
                                    num_useless=2, seed=3)
        exp = tree_lib.TreeParams(max_depth=6, min_records=2)
        sup = D.make_2d_sharded_supersplit(mesh)
        res["example"] = {
            key: _digest(RandomForest(exp, num_trees=3, seed=7,
                                      device="cpu").fit(ex, **kw).trees)
            for key, kw in (("local", {}), ("engine", {"supersplit_fn": sup}),
                            ("closure", {"supersplit_fn":
                                         lambda *a: sup(*a)}))}

        # fit_streamed with the sharded hist engine against in memory
        ds_num = from_numpy(num, None, y)
        bins, edges = ds_num.quantize(_HIST["num_bins"])
        src = ArrayRowSource(bins, edges, y, num_classes=2,
                             chunk_size=STREAM_CHUNK)
        p = tree_lib.TreeParams(**_HIST)
        mesh.reset_log()
        streamed = RandomForest(p, num_trees=TREES, seed=SEED,
                                tree_batch=TREES, device="cpu").fit_streamed(
            src, engine=engines["hist"])
        stream_ops = sorted({(e["op"], e["axis"]) for e in mesh.log})
        in_memory = fit(_HIST, ds_num)
        res["streamed"] = dict(streamed=_digest(streamed.trees),
                               in_memory=_digest(in_memory.trees),
                               ops=stream_ops)
        _tree_arrays("streamed/sharded", streamed.trees, arrays)

        # GBT rounds through the mesh engines against the local GBT
        res["gbt"] = {}
        for mode in ("hist", "exact"):
            gp = GBTParams(num_rounds=3, max_depth=3, loss="squared",
                           split_mode=mode, num_bins=32, min_records=10)
            a = GBTModel(gp, device="cpu").fit(data["regression"])
            b = GBTModel(gp, device="cpu").fit(
                data["regression"],
                engine=engines["hist" if mode == "hist" else "exact_2d"],
                cat_engine=engines["categorical"])
            res["gbt"][mode] = dict(local=_digest(a.trees),
                                    sharded=_digest(b.trees))
            _tree_arrays(f"gbt_{mode}/local", a.trees, arrays)
            _tree_arrays(f"gbt_{mode}/sharded", b.trees, arrays)

        # the 1-bit condition broadcast against local evaluation
        e = engine_inputs()
        bits = D.make_sharded_evaluate(mesh)(
            torch.as_tensor(e["num"].T.copy()), torch.as_tensor(e["leaf"]),
            torch.as_tensor(e["feat"]), torch.as_tensor(e["thr"]), 8)
        arrays["engine/evaluate"] = bits.numpy()

        # the engines on one level's inputs (legacy signatures)
        stats = np.stack([e["w"] * (e["y"] == c) for c in (0, 1)],
                         -1).astype(np.float32)
        targs = [torch.as_tensor(a) for a in (e["sv"], e["si"], e["leaf"],
                                              e["w"], stats, e["cand"])]
        for key, eng in (("exact_2d", engines["exact_2d"]),
                         ("exact_columns", engines["exact_columns"])):
            g, t = eng(*targs, e["L"], "gini", "classification", 1.0)
            arrays[f"engine/{key}/gain"] = g.numpy()
            arrays[f"engine/{key}/thr"] = t.numpy()
        g, t = engines["hist"](
            torch.as_tensor(e["bins"]), torch.as_tensor(e["edges"]),
            torch.as_tensor(e["leaf"]), torch.as_tensor(e["w"]),
            torch.as_tensor(stats), torch.as_tensor(e["cand"]), e["L"],
            "gini", "classification", 1.0)
        arrays["engine/hist/gain"], arrays["engine/hist/thr"] = \
            g.numpy(), t.numpy()
        n = e["y"].shape[0]
        inp = LevelInputs(
            num_cols=torch.zeros((0, n)),
            cat_cols=torch.as_tensor(e["cat"].T.copy()),
            labels=torch.as_tensor(e["y"]), sorted_vals=None,
            sorted_idx=None, leaf_of=torch.as_tensor(e["leaf2"]),
            w=torch.as_tensor(e["w2"]), stats=None, totals=None)
        st = LevelStatics(m_num=0, m_cat=4, max_arity=5, num_classes=2,
                          impurity="gini", task="classification",
                          min_records=1.0)
        g, masks = engines["categorical"].supersplits(
            inp, st, e["L"], torch.as_tensor(e["cand_cat"]))
        arrays["engine/categorical/gain"] = g.numpy()
        arrays["engine/categorical/mask"] = masks.numpy()
        step = D.drf_level_step_fn(mesh, num_leaves=e["L"], num_classes=2)
        bf, bg, bt = step(targs[0], targs[1], targs[2],
                          torch.as_tensor(e["y"]), targs[3], targs[5])
        arrays["engine/level_step/feat"] = bf.numpy()
        arrays["engine/level_step/gain"] = bg.numpy()
        arrays["engine/level_step/thr"] = bt.numpy()

        # shapes the axes do not divide
        errs = {}
        bad = {"m_num": from_numpy(num[:, :7], None, y),
               "n": from_numpy(num[:1023], None, y[:1023]),
               "m_cat": from_numpy(num, cat[:, :3], y)}
        for key, ds in bad.items():
            eng = (engines["categorical"] if key == "m_cat"
                   else engines["exact_2d"])
            kw = ({"cat_engine": eng} if key == "m_cat" else {"engine": eng})
            try:
                fit(_EXACT, ds, **kw)
            except ValueError as err:
                errs[key] = str(err)
        try:
            ShardedHistNumeric(mesh=None)
        except RuntimeError as err:
            errs["no_mesh"] = str(err)
        res["errors"] = errs
    finally:
        dist.destroy_process_group()
    Path(out + ".json").write_text(json.dumps(res))
    if rank == 0:
        np.savez(out + ".npz", **arrays)


# ---------------------------------------------------------------------------
# The reference: local forests and the mesh engines on a 2x2 host mesh
# ---------------------------------------------------------------------------

def reference(out):
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from test_torch_harness import reference as load
    ref = load()
    jnp = ref.jnp
    from repro.core import distributed as D
    from repro.core.level import engines as ref_engines
    from repro.launch.mesh import make_host_mesh

    arrays = {}
    num, cat, y, yreg = make_data()
    data = {"mixed": ref.dataset.from_numpy(num, cat, y),
            "regression": ref.dataset.from_numpy(num, cat, yreg,
                                                 task="regression")}
    done = {}
    for name, (params, kind, _, _) in FORESTS.items():
        params = UNPRUNED if name == "pruned" else params
        key = (json.dumps(params, sort_keys=True), kind)
        if key not in done:
            done[key] = ref.forest.RandomForest(
                ref.tree.TreeParams(**params), num_trees=TREES, seed=SEED,
                tree_batch=TREES).fit(data[kind]).trees
        _tree_arrays(f"{name}/reference", done[key], arrays)
    rf = ref.forest.RandomForest(ref.tree.TreeParams(**_HIST),
                                 num_trees=TREES, seed=SEED,
                                 tree_batch=TREES).fit(
        ref.dataset.from_numpy(num, None, y))
    _tree_arrays("streamed/reference", rf.trees, arrays)

    mesh = make_host_mesh(2, 2)
    e = engine_inputs()
    stats = ref.splits.row_stats(jnp.asarray(e["y"]), jnp.asarray(e["w"]), 2,
                                 "classification")
    jargs = [jnp.asarray(e[k]) for k in ("sv", "si", "leaf", "w")]
    jargs += [stats, jnp.asarray(e["cand"])]
    for key, maker in (("exact_2d", D.make_2d_sharded_supersplit),
                       ("exact_columns", D.make_column_sharded_supersplit)):
        g, t = maker(mesh)(*jargs, e["L"], "gini", "classification", 1.0)
        arrays[f"engine/{key}/gain"] = np.asarray(g)
        arrays[f"engine/{key}/thr"] = np.asarray(t)
    g, t = D.make_hist_sharded_supersplit(mesh)(
        jnp.asarray(e["bins"]), jnp.asarray(e["edges"]),
        jnp.asarray(e["leaf"]), jnp.asarray(e["w"]), stats,
        jnp.asarray(e["cand"]), e["L"], "gini", "classification", 1.0)
    arrays["engine/hist/gain"], arrays["engine/hist/thr"] = \
        np.asarray(g), np.asarray(t)
    n = e["y"].shape[0]
    stats2 = ref.jax.vmap(lambda ww: ref.splits.row_stats(
        jnp.asarray(e["y"]), ww, 2, "classification"))(jnp.asarray(e["w2"]))
    z = jnp.zeros((0, 0))
    inp = ref_engines.LevelInputs(
        num=jnp.zeros((n, 0)), cat=jnp.asarray(e["cat"]),
        labels=jnp.asarray(e["y"]), sorted_vals=z, sorted_idx=z, bin_of=z,
        bin_edges=z, ord_idx=z, leaf_of=jnp.asarray(e["leaf2"]),
        w=jnp.asarray(e["w2"]), stats=stats2, totals=z, row_counts=z)
    st = ref_engines.LevelStatics(m_num=0, m_cat=4, max_arity=5,
                                  num_classes=2, num_bins=32,
                                  impurity="gini", task="classification",
                                  min_records=1.0)
    g, masks = D.make_categorical_sharded_supersplit(mesh).supersplits_batched(
        inp, st, e["L"], jnp.asarray(e["cand_cat"]))
    arrays["engine/categorical/gain"] = np.asarray(g)
    arrays["engine/categorical/mask"] = np.asarray(masks)
    bits = D.make_sharded_evaluate(mesh)(
        jnp.asarray(e["num"].T), jnp.asarray(e["leaf"]),
        jnp.asarray(e["feat"]), jnp.asarray(e["thr"]), 8)
    arrays["engine/evaluate"] = np.asarray(bits)
    step = D.drf_level_step_fn(mesh, num_leaves=e["L"], num_classes=2)
    bf, bg, bt = step(jargs[0], jargs[1], jargs[2], jnp.asarray(e["y"]),
                      jargs[3], jargs[5])
    arrays["engine/level_step/feat"] = np.asarray(bf)
    arrays["engine/level_step/gain"] = np.asarray(bg)
    arrays["engine/level_step/thr"] = np.asarray(bt)
    np.savez(out + ".npz", **arrays)


if __name__ == "__main__":
    if sys.argv[1] == "port":
        port(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    else:
        reference(sys.argv[2])
