"""Leo-shaped rows (paper §5), made on the device from the seed.

3 float32 numeric columns (standard normal) and one int32 categorical
column per arity of the configuration, uniform over its categories.  The
label is 1 where 1.5 · num[0] plus a seeded per-category effect of four
categorical columns is positive, flipped with probability 5%.
"""
import torch


def make(config: dict, seed: int, device):
    """(num (n, 3) float32, cat (n, 79) int32, labels (n,) int64, arities)."""
    n, arities = int(config["rows"]), tuple(config["arities"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    num = torch.randn((n, config["numeric"]), generator=g, device=device)
    a = torch.tensor(arities, dtype=torch.float32, device=device)
    cat = torch.rand((n, len(arities)), generator=g, device=device).mul_(a)
    cat = torch.minimum(cat.floor_(), a - 1).to(torch.int32)
    rule = config["label"]
    logit = rule["numeric_weight"] * num[:, 0]
    for j in rule["effect_columns"]:
        effect = torch.randn(arities[j], generator=g, device=device)
        logit = logit + effect[cat[:, j].long()]
    flip = torch.rand(n, generator=g, device=device) < rule["noise"]
    return num, cat, (logit > 0).long() ^ flip.long(), arities
