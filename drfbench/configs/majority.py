"""The paper's artificial "majority" rows (§4), made on the device from the
seed: informative and useless standard normal float32 columns; the label
is 1 where more than half of the informative columns are positive."""
import torch


def make(config: dict, seed: int, device):
    """(num (n, m) float32, cat (n, 0) int32, labels (n,) int64, ())."""
    n, k = int(config["rows"]), int(config["informative"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    num = torch.randn((n, k + config["useless"]), generator=g, device=device)
    y = ((num[:, :k] > 0).sum(1) > k / 2).long()
    cat = torch.zeros((n, 0), dtype=torch.int32, device=device)
    return num, cat, y, ()
