"""The Poisson bag kernel (`kernels/bagging.py`, `csrc/bagging.cu`) against
its plain version, `prng.poisson_knuth`, which `test_torch_prng.py` holds
bit-equal to `jax.random.poisson`.

CPU legs: `bag_counts_forest(mode="poisson")` takes the plain loop on the
CPU and leaves the kernel's counters alone; the wrapper refuses what the
kernel does not take.  The legs marked `gpu` need a card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_bag_kernel.py

They hold the kernel bit-equal to the plain loop on the card (main-path
sizes included), its log against `torch.log` over every uniform a draw
can give, and its counters to one launch a call.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import bagging, prng
from repro_torch.kernels import bagging as bag_kernel


def _plain(seed, trees, n, device):
    keys = prng.fold_in(prng.prng_key(seed, device)[None, :],
                        torch.tensor(trees, dtype=torch.int64, device=device))
    return prng.poisson_knuth(keys, 1.0, (n,)).to(torch.float32)


def _trees(T):
    """T tree indices in [0, 499], the first and last included."""
    return [0] + [499 - 61 * i for i in range(T - 1)]


@pytest.mark.parametrize("seed, T, n", [(0, 1, 1), (5, 2, 7),
                                        (2**31 + 7, 3, 1000)])
def test_cpu_takes_the_plain_loop_and_counts_no_launch(seed, T, n):
    launches, rows = bag_kernel.launches, bag_kernel.rows
    got = bagging.bag_counts_forest(seed, _trees(T), n, "poisson", "cpu")
    assert got.dtype == torch.float32 and got.shape == (T, n)
    assert torch.equal(got, _plain(seed, _trees(T), n, "cpu"))
    assert torch.equal(bagging.bag_counts_forest(seed, _trees(T), n),
                       got)                       # device None: the CPU
    assert (bag_kernel.launches, bag_kernel.rows) == (launches, rows)


def test_cpu_draws_no_rows_and_no_trees():
    assert bagging.bag_counts_forest(3, [], 10, device="cpu").shape == (0, 10)
    assert bagging.bag_counts_forest(3, [1, 2], 0, device="cpu").shape == \
        (2, 0)


@pytest.mark.parametrize("call, match", [
    (lambda: bagging.bag_counts_forest(0, [0], 10, "bootstrap", "cpu"),
     "unknown bagging mode"),
    (lambda: bagging.bag_counts_forest(0, [0], 1 << 32, "poisson", "cpu"),
     "2\\*\\*32"),
    (lambda: bag_kernel.poisson(prng.prng_key(0), [0], -1, "cpu"),
     "2\\*\\*32"),
    (lambda: bag_kernel.poisson(prng.prng_key(0, "meta"), [0], 10, "cpu"),
     "read on the host"),
    (lambda: bag_kernel.poisson(prng.prng_key(0), [0], 10, "meta"),
     "CUDA or CPU"),
    (lambda: bag_kernel.poisson(prng.prng_key(0).to(torch.int32), [0], 10,
                                "cpu"), "int64 \\(2,\\)"),
    (lambda: bag_kernel.poisson(torch.zeros(3, dtype=torch.int64), [0], 10,
                                "cpu"), "int64 \\(2,\\)"),
])
def test_bad_arguments_are_refused(call, match):
    with pytest.raises(ValueError, match=match):
        call()


def test_bound_counts_the_write_and_the_threefry_passes():
    assert bag_kernel.bound_bytes(2, 10) == 80
    assert bag_kernel.bound_int_ops(3) == 3 * 80


# ---------------------------------------------------------------------------
# CUDA legs: the kernel against the plain loop on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is built with nvcc and "
                    "runs only on the GPU")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 7, 65_537, (1 << 23) + 3])
@pytest.mark.parametrize("T", [1, 2, 8])
@pytest.mark.parametrize("seed", [0, 5, 2**31 + 7])
def test_kernel_bit_equal_to_plain_on_the_card(cuda, seed, T, n):
    trees = _trees(T)
    got = bagging.bag_counts_forest(seed, trees, n, "poisson", cuda)
    want = _plain(seed, trees, n, cuda)
    assert got.dtype == torch.float32 and got.shape == (T, n)
    assert torch.equal(got, want)
    if n > 1 << 23:
        # rows past the kernel's 8-subkey table continue the chain
        assert int(got.max().item()) >= 8


@pytest.mark.gpu
def test_kernel_at_one_cards_leo_share(cuda):
    n = 3 * (1 << 24)
    got = bagging.bag_counts(2718281828, 17, n, "poisson", cuda)
    want = _plain(2718281828, [17], n, cuda)[0]
    assert torch.equal(got, want)
    assert abs(got.double().mean().item() - 1.0) < 1e-3


@pytest.mark.gpu
def test_kernel_log_equals_torch_log_over_every_uniform(cuda):
    k = torch.arange(bag_kernel.UNIFORMS, dtype=torch.int32, device=cuda)
    u = (k | 0x3F800000).view(torch.float32) - 1.0       # bits k << 9
    assert torch.equal(u.double(), k.double() * 2.0 ** -23)
    got = bag_kernel.uniform_log(cuda)
    want = torch.log(u)
    assert got[0].item() == -np.inf
    diff = (got.view(torch.int32) != want.view(torch.int32)).nonzero()
    assert diff.numel() == 0, (
        f"{diff.numel()} uniforms differ, first at k = "
        f"{diff[:8].flatten().tolist()}")


@pytest.mark.gpu
def test_counters_advance_once_a_call(cuda):
    launches, rows = bag_kernel.launches, bag_kernel.rows
    bagging.bag_counts_forest(1, [3, 4, 5], 1000, "poisson", cuda)
    assert (bag_kernel.launches, bag_kernel.rows) == (launches + 1,
                                                      rows + 3000)
    bagging.bag_counts(1, 3, 999, "poisson", cuda)
    assert (bag_kernel.launches, bag_kernel.rows) == (launches + 2,
                                                      rows + 3999)
    # more trees than one launch's parameters hold: still one call
    trees = list(range(300))
    got = bagging.bag_counts_forest(1, trees, 100, "poisson", cuda)
    assert bag_kernel.launches == launches + 3
    assert torch.equal(got, _plain(1, trees, 100, cuda))
