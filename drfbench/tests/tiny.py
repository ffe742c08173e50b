"""A checkout of the benchmark's data at a size the CPU tests can run:
the committed configurations cut to a few thousand rows, depth 4 and two
trees a fit, everything else (traffic, metrics, limits) as committed."""
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CELLS = ("leo.exact-kernel", "majority.exact-segment", "majority.hist",
         "majority.hist-streamed")


def make_root(dest: Path, rows: int = 3000) -> Path:
    shutil.copytree(REPO / "drfbench", dest / "drfbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        cfg.update(rows=rows, trees_per_fit=2)
        cfg["tree"]["max_depth"] = 4
        if "arities" in cfg:            # every 8th column, up to 10,000
            cfg["arities"] = cfg["arities"][::8]
            cfg["label"]["effect_columns"] = [2, 5, 7, 9]
        (dest / c["file"]).write_text(json.dumps(cfg))
    for t in (dest / "drfbench" / "traffic").glob("*.json"):
        tr = json.loads(t.read_text())
        if "chunk_size" in tr:
            tr["chunk_size"] = rows // 3
            t.write_text(json.dumps(tr))
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    return dest
