"""Multinomial bagging (n-out-of-n with replacement, the paper's stated
scheme) in the port vs the reference: the draws come from the port's copy
of `jax.random.randint`, so the bag counts are bit-equal, and the forests
grown from them equal the reference's node for node.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import bagging, prng
from test_torch_forest import assert_trees_equal, fit_both, port_ds
from test_torch_harness import reference


@pytest.mark.parametrize("n", [1, 7, 1000, 65537, 1 << 20])
def test_multinomial_bag_counts_match_reference(n):
    ref = reference()
    trees = [0, 3, 11]
    want = np.asarray(ref.bagging.bag_counts_forest(
        5, ref.jnp.asarray(trees, ref.jnp.int32), n, "multinomial"))
    got = bagging.bag_counts_forest(5, trees, n, "multinomial", "cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.sum(1).numpy(), [n] * len(trees))
    np.testing.assert_array_equal(
        bagging.bag_counts(5, 3, n, "multinomial", "cpu").numpy(), want[1])


@pytest.mark.parametrize("seed,lo,hi", [
    (0, 0, 1), (1, 0, 2), (7, 3, 17), (9, -5, 1000), (2, 0, (1 << 31) - 1),
    (4, -(1 << 31), (1 << 31) - 1), (3, 10, 10), (5, 10, 4)])
def test_randint_matches_jax(seed, lo, hi):
    ref = reference()
    want = np.asarray(ref.jax.random.randint(ref.jax.random.PRNGKey(seed),
                                             (4097,), lo, hi))
    got = prng.randint(prng.prng_key(seed), (4097,), lo, hi)
    np.testing.assert_array_equal(got.numpy(), want)


def test_randint_batches_over_a_leading_key_axis():
    keys = prng.fold_in(prng.prng_key(3)[None, :], torch.arange(4))
    got = prng.randint(keys, (5, 6), 0, 100)
    assert got.shape == (4, 5, 6)
    for t in range(4):
        np.testing.assert_array_equal(
            got[t].numpy(), prng.randint(keys[t], (5, 6), 0, 100).numpy())


@pytest.mark.parametrize("backend", ["segment", "kernel"])
def test_multinomial_forest_matches_reference(backend):
    ref = reference()
    rds = ref.synthetic.make_tabular("xor", n=900, num_informative=3,
                                     num_useless=1, num_categorical=2,
                                     seed=2)
    kw = dict(max_depth=7, bagging="multinomial")
    r, p = fit_both(rds, kw, dict(kw, backend=backend), 3, 4, 3, 2)
    assert_trees_equal(r.trees, p.trees)
    w = bagging.bag_counts_forest(4, range(3), 900, "multinomial", "cpu")
    oob = (w == 0).float().mean().item()
    assert 0.3 < oob < 0.45                       # about 1/e left out
    assert p.oob_score(port_ds(rds)) == r.oob_score(rds)
