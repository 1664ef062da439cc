"""The port's sampling bits held against ``jax.random`` and the reference.

* ``PRNGKey``, ``fold_in`` and ``random_bits`` are bit-equal to
  ``jax.random.PRNGKey`` / ``fold_in`` / ``bits`` under both of JAX's
  threefry layouts (``jax.threefry_partitionable`` True and False), over a
  grid of seeds, steps and widths (odd widths, the reduced vocabulary,
  deepseek-7b's 102400); ``uniform`` is bit-equal to
  ``jax.random.uniform(minval=tiny)``.
* ``gumbel`` is within 1e-6 of ``jax.random.gumbel``: ``-log(-log(u))``
  over every one of the 2**23 float32 values ``u`` can take agrees within
  1e-6 (``torch.log`` and XLA's ``log`` differ by 1 ulp on some inputs).
* ``sample_tokens`` equals ``repro.serve.sampling.sample_tokens`` on random
  logits with greedy and sampled rows; every compared sampled row's two
  best perturbed logits lie more than 4e-6 apart, so the 1e-6 noise
  difference cannot decide it (a failure of that check names a near tie).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.serve import sampling as jax_sampling  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.serve import prng  # noqa: E402
from repro_torch.serve.sampling import request_key, sample_tokens  # noqa: E402

TINY = np.finfo(np.float32).tiny
SEEDS = [0, 1, 7, 2 ** 31 - 1, 123456789]
STEPS = [0, 1, 5, 1023]
WIDTHS = [1, 2, 7, 255, get_config("deepseek-7b", reduced=True).vocab_size,
          102400]
GUMBEL_TOL = 1e-6
MARGIN = 4e-6


@pytest.mark.parametrize("partitionable", [True, False])
def test_keys_and_bits_equal_jax(partitionable):
    with jax.threefry_partitionable(partitionable):
        for seed in SEEDS:
            key = prng.PRNGKey(seed)
            jkey = jax.random.PRNGKey(seed)
            np.testing.assert_array_equal(key, np.asarray(jkey))
            for step in STEPS:
                k = prng.fold_in(key, step)
                jk = jax.random.fold_in(jkey, step)
                np.testing.assert_array_equal(k, np.asarray(jk))
                for n in WIDTHS:
                    got = prng.random_bits(k[None], n,
                                           partitionable=partitionable)
                    want = np.asarray(jax.random.bits(jk, (n,), jnp.uint32))
                    np.testing.assert_array_equal(
                        got[0].numpy(), want.astype(np.int64),
                        err_msg=f"seed {seed} step {step} n {n}")


def test_bits_of_a_key_batch_are_each_keys_bits():
    keys = prng.fold_in(prng.PRNGKey(3), np.arange(5))
    for partitionable in (True, False):
        both = prng.random_bits(keys, 33, partitionable=partitionable)
        for i in range(5):
            one = prng.random_bits(keys[i:i + 1], 33,
                                   partitionable=partitionable)
            assert torch.equal(both[i], one[0])


def test_fold_in_batch_and_request_key_equal_jax():
    base = jax.random.PRNGKey(0)
    seeds = np.array([0, 3, 11, 2 ** 32 - 1])
    want = np.stack([np.asarray(jax_sampling.request_key(base, int(s)))
                     for s in seeds])
    np.testing.assert_array_equal(request_key(prng.PRNGKey(0), seeds), want)
    with pytest.raises(OverflowError):
        jax.random.fold_in(base, -1)
    with pytest.raises(OverflowError):
        prng.fold_in(prng.PRNGKey(0), -1)


@pytest.mark.parametrize("partitionable", [True, False])
def test_uniform_bit_equal_and_gumbel_within_tolerance(partitionable):
    with jax.threefry_partitionable(partitionable):
        for seed, step in [(0, 0), (7, 3), (123456789, 1023)]:
            k = prng.fold_in(prng.PRNGKey(seed), step)
            jk = jax.random.fold_in(jax.random.PRNGKey(seed), step)
            for n in (7, 102400):
                u = prng.uniform(k[None], n, partitionable=partitionable)
                ju = np.asarray(jax.random.uniform(jk, (n,), minval=TINY))
                np.testing.assert_array_equal(u[0].numpy().view(np.int32),
                                              ju.view(np.int32))
                g = prng.gumbel(k[None], n, partitionable=partitionable)
                jg = np.asarray(jax.random.gumbel(jk, (n,)))
                assert np.abs(g[0].numpy() - jg).max() <= GUMBEL_TOL


def test_gumbel_over_every_uniform_value():
    """All 2**23 values of ``u`` (the mantissas of [1, 2) minus 1, the first
    raised to tiny): torch's and XLA's ``-log(-log(u))`` differ in some, by
    at most 1e-6 (1 ulp at the noise's largest values)."""
    mant = torch.arange(2 ** 23, dtype=torch.int64)
    f = (mant | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    u = torch.clamp_min(f, float(TINY))
    ours = (-torch.log(-torch.log(u))).numpy()
    theirs = np.asarray(jax.jit(lambda x: -jnp.log(-jnp.log(x)))(u.numpy()))
    diff = np.abs(ours - theirs)
    n_diff = int((ours.view(np.int32) != theirs.view(np.int32)).sum())
    log_t = torch.log(u).numpy().view(np.int32)
    log_j = np.asarray(jax.jit(jnp.log)(u.numpy())).view(np.int32)
    print(f"log differs in {int((log_t != log_j).sum())}, gumbel noise in "
          f"{n_diff} of {2 ** 23} values of u, max abs {diff.max():.3g}")
    assert diff.max() <= GUMBEL_TOL
    assert np.isfinite(ours).all()


def _perturbed(logits, keys, steps, temps):
    """The port's perturbed logits of every row (noise + logits / T)."""
    k = prng.fold_in(keys, steps)
    noise = prng.gumbel(k, logits.shape[1])
    temp = torch.maximum(torch.as_tensor(temps), torch.tensor(1e-6))
    return noise + torch.as_tensor(logits) / temp[:, None]


@pytest.mark.parametrize("V", [7, 512, 102400])
def test_sample_tokens_equals_reference(V):
    """In the partitionable layout, the one the port's engine samples in."""
    rng = np.random.default_rng(V)
    B = 8
    logits = (rng.standard_normal((B, V)) * 4).astype(np.float32)
    temps = np.array([0.0, 0.8, 0.3, 0.0, 1.7, 0.05, 1.0, 0.0], np.float32)
    keys = request_key(prng.PRNGKey(0), np.arange(B) * 5 + 1)
    steps = np.array([0, 1, 2, 3, 17, 100, 4095, 9], np.int32)
    got = sample_tokens(torch.tensor(logits), keys, steps, temps)
    with jax.threefry_partitionable(True):
        want = np.asarray(jax_sampling.sample_tokens(
            jnp.asarray(logits), jnp.asarray(keys), jnp.asarray(steps),
            jnp.asarray(temps)))
    top2 = torch.topk(_perturbed(logits, keys, steps, temps), 2,
                      dim=-1).values
    for b in np.flatnonzero(temps > 0):
        gap = float(top2[b, 0] - top2[b, 1])
        assert gap > MARGIN, (f"row {b}: near tie, the two best perturbed "
                              f"logits {gap:.3g} apart")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    greedy = np.flatnonzero(temps == 0)
    np.testing.assert_array_equal(got.numpy()[greedy],
                                  logits[greedy].argmax(-1))


def test_greedy_rows_draw_no_noise(monkeypatch):
    """A batch of greedy rows never computes the Gumbel noise."""
    import repro_torch.serve.sampling as sampling
    calls = []
    monkeypatch.setattr(sampling, "gumbel",
                        lambda *a, **k: calls.append(1))
    logits = torch.tensor([[1.0, 3.0, 3.0], [2.0, 0.0, 1.0]])
    out = sampling.sample_tokens(logits, np.zeros((2, 2), np.uint32),
                                 [0, 0], [0.0, 0.0])
    assert out.tolist() == [1, 0] and calls == []
