"""Multi-process smoke run over `torch.distributed`, ported from
`repro.launch.multihost_smoke`.

    python -m repro_torch.launch.multihost_smoke [--nproc N] [--device cpu|cuda]

The launcher starts N worker processes that meet through a `FileStore` in
a fresh temporary directory (no port to pick).  Each worker joins a gloo
group of all N processes, builds a (data=N, model=1) mesh spanning every
process, and trains the reference's tiny sharded-hist forest (8 numeric
columns, 512 rows, depth 3, 16 bins, 2 trees) through
`RandomForest.fit(engine=ShardedHistNumeric(...))`, so the engine's
all-reduce crosses the process boundary; it asserts that forest equals
its own one-process fit and prints

    MULTIHOST-SMOKE-OK mode=global pid=<rank> fp=<sha1 of the trees>

The launcher asserts N such lines with one fingerprint (N must divide
the 512 rows).  gloo crosses
processes on the CPU as well, so there is only the reference's `global`
mode (the reference falls back to a per-process mesh on the CPU, where
jax has no cross-process collectives).  Like every entry point of the
port it runs on the card unless asked for the CPU (`--device cpu`, or
`main(device="cpu")`): every worker then trains on the current card
(gloo, since several ranks share it and NCCL takes one card a rank).
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import tempfile


def _forest_fingerprint(forest) -> str:
    """Order-stable digest of every tree's flat arrays."""
    import numpy as np
    h = hashlib.sha1()
    for t in forest.trees:
        for name in ("feature", "threshold", "is_cat", "cat_mask",
                     "children", "value", "n_node", "gain", "depth"):
            h.update(np.ascontiguousarray(getattr(t, name)).tobytes())
    return h.hexdigest()


def _train(mesh, device) -> str:
    """The fingerprint of the sharded-hist forest, asserted equal to the
    local forest's."""
    import numpy as np

    from repro_torch.core import tree as tree_lib
    from repro_torch.core.dataset import from_numpy
    from repro_torch.core.forest import RandomForest
    from repro_torch.core.level.sharded import ShardedHistNumeric

    rng = np.random.default_rng(7)
    n = 512
    num = rng.normal(size=(n, 8)).astype(np.float32)
    y = ((num[:, 0] + num[:, 1] * num[:, 2]) > 0).astype(np.int32)
    ds = from_numpy(num, None, y)
    p = tree_lib.TreeParams(max_depth=3, leaf_pad=8, split_mode="hist",
                            num_bins=16)
    local = RandomForest(p, num_trees=2, seed=11, tree_batch=2,
                         device=device).fit(ds)
    dist_rf = RandomForest(p, num_trees=2, seed=11, tree_batch=2,
                           device=device).fit(
        ds, engine=ShardedHistNumeric(mesh=mesh))
    a, b = _forest_fingerprint(local), _forest_fingerprint(dist_rf)
    if a != b:
        raise AssertionError("sharded-hist forest != one-process forest")
    if not any(e["op"] == "all_reduce_sum" for e in mesh.log):
        raise AssertionError("no all-reduce crossed the processes")
    return a


def worker(pid: int, nproc: int, store_path: str, device=None) -> None:
    import torch.distributed as dist

    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_mesh

    dev = resolve_device(device)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, nproc),
                            rank=pid, world_size=nproc)
    try:
        mesh = make_mesh(nproc, 1, backend="gloo", device=dev)
        fp = _train(mesh, dev)
        print(f"MULTIHOST-SMOKE-OK mode=global pid={pid} fp={fp}",
              flush=True)
    finally:
        dist.destroy_process_group()


def main(nproc: int = 2, timeout: float = 300.0, device=None) -> dict:
    """Spawn the workers, collect and validate their output.  `device`
    None (the default) or "cuda" is the card, and raises without one;
    "cpu" runs the workers on the CPU."""
    from repro_torch.device import resolve_device
    kind = resolve_device(device).type      # fails here, before any spawn
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (src, env.get("PYTHONPATH")) if p)
    with tempfile.TemporaryDirectory(prefix="multihost_smoke_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.multihost_smoke",
             "--worker", str(i), str(nproc), store, kind],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env) for i in range(nproc)]
        outs = []
        try:
            for p in procs:
                out, _ = p.communicate(timeout=timeout)
                outs.append(out)
                if p.returncode != 0:
                    raise RuntimeError(f"worker exited {p.returncode}:\n"
                                       f"{out[-3000:]}")
        finally:
            # a failed worker must not leave its peers waiting in a
            # collective for the rest of the timeout
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    oks = [line for out in outs for line in out.splitlines()
           if line.startswith("MULTIHOST-SMOKE-OK")]
    if len(oks) != nproc:
        raise RuntimeError(f"expected {nproc} OK lines: {outs}")
    fps = {line.split("fp=")[1] for line in oks}
    if len(fps) != 1:
        raise RuntimeError(f"processes disagree: {oks}")
    mode = oks[0].split("mode=")[1].split()[0]
    print(f"multihost smoke: {nproc} processes OK, mode={mode}, "
          f"fingerprint {fps.pop()[:12]}")
    return {"nproc": nproc, "mode": mode, "fingerprints": 1}


if __name__ == "__main__":
    if "--worker" in sys.argv:
        i = sys.argv.index("--worker")
        worker(int(sys.argv[i + 1]), int(sys.argv[i + 2]), sys.argv[i + 3],
               sys.argv[i + 4])
    else:
        import argparse
        ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
        ap.add_argument("--nproc", type=int, default=2)
        ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                        help="default: the card")
        a = ap.parse_args()
        main(a.nproc, device=a.device)
