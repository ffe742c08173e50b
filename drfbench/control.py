"""The readings the limits of `drfbench/limits/<cell>.json` are set from.

    python3 drfbench/control.py --workload leo.exact-kernel \
        --program-seeds 1 2 3 ... --control-seeds 101 102 103

For each program seed: the cell's rows and one fit of `trees_per_fit`
trees through the cell's own path (as the timed window trains them), every
tree judged by the reference.  For each control seed: the same trees grown
by the reference itself in bfloat16, the precision below the float32 the
configuration states, and judged the same way.  One JSON line per seed
with the worst reading of each number over its trees.  Runs on CUDA; the
tests call `readings` on the CPU.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def readings(name: str, seed: int, control: bool, device: str,
             root: Path = ROOT) -> dict:
    """Worst readings over one fit's trees: the program's, or with
    `control` the bfloat16 reference's."""
    import torch
    from drfbench import harness
    from drfbench.reference.forest import check_tree, grow
    cell = harness.load_cell(name, root)
    dev = torch.device(device)
    rows = harness.make_rows(cell, seed, dev)
    fs = harness.forest_seed(seed, 0)
    T = int(cell.config["trees_per_fit"])
    t0 = time.perf_counter()
    if control:
        P = harness.problem(cell, *rows, dev)
        trees = [grow(P, fs, t) for t in range(T)]
    else:
        trees = harness.fit_trees(cell, rows, fs, T, device)
        P = harness.problem(cell, *rows, dev)
    grown = time.perf_counter() - t0
    worst = {}
    for t, tree in enumerate(trees):
        for k, v in check_tree(P, tree, fs, t).items():
            worst[k] = max(worst.get(k, 0.0), float(v))
    return dict(workload=name, seed=seed,
                kind="control" if control else "program", trees=T,
                grow_s=grown, check_s=time.perf_counter() - t0 - grown,
                **worst)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("drfbench.control: no CUDA device", file=sys.stderr)
        return 2
    for seeds, control in ((args.program_seeds, False),
                           (args.control_seeds, True)):
        for s in seeds:
            print(json.dumps(readings(args.workload, s, control, "cuda")),
                  flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
