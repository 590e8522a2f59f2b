"""The jump kernel's filtered loop (csrc/jump_hash.cu), modelled in NumPy,
against the reference's jump_hash_np and the Pallas kernel in interpret
mode, on keys and single steps near the rule's boundaries.

The kernel forms Y, a product within REL_BOUND of Go's p, from the
reciprocal seed and FMAs, reads floor(Y) and 14 fraction bits, and takes
Go's own p where Y lies within 2^-14 of an integer. The model perturbs p by
-REL_BOUND, 0 and +REL_BOUND in place of the seed (whose bits exist only on
the card; chip_smoke.py checks its error bound there over every divisor).
Boundary keys: tests/test_torch_jump.py's adversarial keys and keys whose
loop meets a quotient (b+1) 2^31 / d within 2^-20 of an integer
(synth.jump_boundary_keys); boundary steps: quotients exactly at or within
2^-20 of an integer and of n.

Tolerance: bit-equality (integer buckets).
"""
import numpy as np
import pytest

from hulk_tpu.hashes.jumphash import jump_hash_np
from hulk_tpu.ops.jump_pallas import jump_hash_pallas
from hulk_tpu_torch.synth import jump_boundary_keys

from test_torch_jump import LANES, adversarial_keys
from test_torch_kernel_math import (FRAC_BITS, REL_BOUND, TWO31, filtered_step,
                                    model_jump)

NS = [1, 194481, 923521, 2**31 - 1]
PERTURB = (-REL_BOUND, 0.0, REL_BOUND)


@pytest.fixture(scope="module")
def boundary_keys():
    near = jump_boundary_keys(np.random.default_rng(0))
    assert near.size >= 20
    return np.concatenate([adversarial_keys(), near])


@pytest.mark.parametrize("n", NS)
def test_filtered_loop_matches_numpy_and_pallas(boundary_keys, n):
    keys = np.concatenate([boundary_keys,
                           np.zeros((-boundary_keys.size) % LANES, np.uint64)])
    want = jump_hash_np(keys, n)
    assert np.array_equal(np.asarray(jump_hash_pallas(keys, n, interpret=True)), want)
    for perturb in PERTURB:
        got, exact = model_jump(keys, n, perturb)
        assert np.array_equal(got, want)
        if n > 1:  # the keys' near-integer quotients take the exact step
            assert exact > 0


def go_step(bp1: np.ndarray, d: np.ndarray, n: int):
    """Go's step: trunc(p) and whether the loop goes on."""
    p = bp1 * (TWO31 / d)
    return p.astype(np.int64), p < n


def boundary_steps(n: int, rng) -> tuple[np.ndarray, np.ndarray]:
    """(b + 1, d) pairs whose quotient x = (b+1) 2^31 / d lies within 2^-20
    of n (b + 1 <= n, d <= 2^31: every such pair for n < 10^6, else the
    ones with b + 1 within 2^11 of n), or exactly on an integer (d divides
    (b+1) 2^31), or one off such a d."""
    lo = 1 if n < 10**6 else max(1, n - 2048)
    bp1 = np.arange(lo, n + 1, dtype=np.int64)
    d = np.clip((bp1 << 31) // n + np.array([[0], [1]]), 1, 1 << 31)
    near = np.abs((bp1 << 31) - n * d) * (1 << 20) < d
    bp1, d = np.broadcast_to(bp1, d.shape)[near], d[near]
    assert bp1.size and np.array_equal(bp1[d == 1 << 31][-1:], [n])  # x = n exactly
    c = rng.integers(1, 1 << 15, size=4000)
    q = rng.integers(1, 1 << 16, size=4000)
    e = rng.integers(0, 16, size=4000)
    on = np.stack([c * q, c << e])  # x = q 2^(31 - e), an integer
    on = on[:, (on[0] <= n) & (on[1] <= 1 << 31)]
    d_off = np.clip(on[1] + rng.choice([-1, 1], size=on.shape[1]), 1, 1 << 31)
    return (np.concatenate([bp1, on[0], on[0]]).astype(np.float64),
            np.concatenate([d, on[1], d_off]).astype(np.float64))


@pytest.mark.parametrize("n", NS)
def test_filtered_step_at_integers_and_n(n):
    bp1, d = boundary_steps(n, np.random.default_rng(n))
    want_f, want_go = go_step(bp1, d, n)
    for perturb in PERTURB:
        f, in_range, exact = filtered_step(bp1 - 1.0, d, perturb)
        go = in_range & (f < n)
        assert np.array_equal(go, want_go)
        assert np.array_equal(f[go], want_f[go])
        if perturb:  # below 2^31, a quotient within 2^-20 of an integer is read exactly
            p = bp1 * (TWO31 / d)
            assert exact[(np.abs(p - want_f) < 2.0**-19) & (p < TWO31)].all()


def test_proved_bound_below_the_margin():
    """The constants of csrc/jump_hash.cu's proof: with a seed error of at
    most 2^-16, |Y - p| <= x (e0^3 + 4u + 2.02 e0 u + 2u^2) stays within
    REL_BOUND of p and, for x < 2^31 (1 + 2^-46), below the 2^-14 that the
    14 fraction bits resolve."""
    e0, u = 2.0**-16, 2.0**-53
    rel = e0**3 + 4 * u + 2.02 * e0 * u + 2 * u * u
    assert rel * (1 + 2.0**-46) <= REL_BOUND
    assert TWO31 * (1 + 2.0**-46) * rel < 2.0**-FRAC_BITS / 4
