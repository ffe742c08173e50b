"""The port's threefry generator and seeded bagging vs `jax.random` and
`repro.core.bagging`: every draw bit-equal."""
import jax
import numpy as np
import pytest
import torch

from repro_torch.core import bagging, prng
from test_torch_harness import reference


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def _np(key_or_arr):
    try:
        return np.asarray(jax.random.key_data(key_or_arr))
    except TypeError:
        return np.asarray(key_or_arr)


SEEDS = [0, 1, 7, 12345, 2**31 - 1, 0x5EED ^ 3]


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split_match_jax(seed):
    k = _jkey(seed)
    tk = prng.prng_key(seed)
    np.testing.assert_array_equal(prng.prng_key(seed).numpy(), _np(k))
    for d in (0, 1, 5, 1000, 2**31 - 1):
        np.testing.assert_array_equal(prng.fold_in(tk, d).numpy(),
                                      _np(jax.random.fold_in(k, d)))
    for num in (2, 3, 5):
        np.testing.assert_array_equal(prng.split(tk, num).numpy(),
                                      _np(jax.random.split(k, num)))


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("shape", [(1,), (7,), (1000,), (3, 82)])
def test_uniform_matches_jax(seed, shape):
    k = jax.random.fold_in(_jkey(seed), 9)
    tk = prng.fold_in(prng.prng_key(seed), 9)
    np.testing.assert_array_equal(prng.uniform(tk, shape).numpy(),
                                  np.asarray(jax.random.uniform(k, shape)))


@pytest.mark.parametrize("seed", [0, 3, 99])
@pytest.mark.parametrize("n", [1, 1000, 65_537])
def test_poisson_matches_jax(seed, n):
    k = jax.random.fold_in(_jkey(seed), 2)
    tk = prng.fold_in(prng.prng_key(seed), 2)
    np.testing.assert_array_equal(
        prng.poisson_knuth(tk, 1.0, (n,)).numpy(),
        np.asarray(jax.random.poisson(k, 1.0, (n,))))


def test_batched_keys_draw_per_key():
    """A leading key axis (the tree axis) draws what each key draws alone."""
    keys = prng.fold_in(prng.prng_key(4)[None], torch.arange(3))
    batched = prng.poisson_knuth(keys, 1.0, (500,))
    for t in range(3):
        np.testing.assert_array_equal(
            batched[t].numpy(),
            prng.poisson_knuth(keys[t], 1.0, (500,)).numpy())


@pytest.mark.parametrize("seed", [0, 5, 123])
@pytest.mark.parametrize("tree_idx", [0, 1, 7])
def test_bag_counts_match_reference(seed, tree_idx):
    ref = reference()
    for n in (10, 4097):
        np.testing.assert_array_equal(
            bagging.bag_counts(seed, tree_idx, n).numpy(),
            np.asarray(ref.bagging.bag_counts(seed, tree_idx, n)))


@pytest.mark.parametrize("mode", ["poisson", "none"])
def test_bag_counts_forest_match_reference(mode):
    ref = reference()
    tidx = [0, 3, 4, 11]
    got = bagging.bag_counts_forest(2, tidx, 3000, mode).numpy()
    want = np.asarray(ref.bagging.bag_counts_forest(
        2, jax.numpy.asarray(tidx, jax.numpy.int32), 3000, mode))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32


def test_multinomial_bagging_is_not_ported():
    """Multinomial bagging raised until it was ported; it now draws the
    reference's counts (more sizes in test_torch_bagging.py)."""
    ref = reference()
    got = bagging.bag_counts(0, 0, 10, "multinomial").numpy()
    np.testing.assert_array_equal(
        got, np.asarray(ref.bagging.bag_counts(0, 0, 10, "multinomial")))
    assert got.sum() == 10


@pytest.mark.parametrize("seed", [0, 17])
@pytest.mark.parametrize("usb", [False, True])
@pytest.mark.parametrize("m,m_prime", [(9, 3), (82, 10), (5, 5)])
def test_candidate_features_match_reference(seed, usb, m, m_prime):
    ref = reference()
    for tree_idx in (0, 2):
        jk = jax.random.fold_in(_jkey(seed ^ 0x5EED), tree_idx)
        tk = prng.fold_in(prng.prng_key(seed ^ 0x5EED), tree_idx)
        for depth in (0, 3):
            for num_leaves in (8, 64):
                want = np.asarray(ref.bagging.candidate_features(
                    jk, depth, num_leaves, m, m_prime, usb))
                got = bagging.candidate_features(tk, depth, num_leaves, m,
                                                 m_prime, usb).numpy()
                np.testing.assert_array_equal(got, want)
                assert (got.sum(1) == m_prime).all()


def test_candidate_features_padding_independent():
    """Row h never depends on the padded leaf count, so padded and unpadded
    frontiers draw the same candidates (and a batch of keys draws what
    each key draws alone)."""
    keys = prng.fold_in(prng.prng_key(1)[None], torch.arange(3))
    small = bagging.candidate_features(keys, 2, 8, 82, 10)
    big = bagging.candidate_features(keys, 2, 64, 82, 10)
    np.testing.assert_array_equal(small.numpy(), big[:, :8].numpy())
    for t in range(3):
        np.testing.assert_array_equal(
            big[t].numpy(),
            bagging.candidate_features(keys[t], 2, 64, 82, 10).numpy())
