"""The port's plain minimizer window (minimizer_window_torch) against the
reference's XLA form (hulk_tpu.ops.minimizer.minimizer_window) and its Pallas
kernel in interpret mode, on the constructions of tests/test_minimizer.py:
k < w, symmetric-heavy, k = 28..31, N-rich, ragged lengths, and L not a
multiple of 128. Bytes past each read's length are random in the port's
input: they must not matter.

Tolerance: bit-equality of both outputs at every lane (the Pallas kernel's
window minima are compared where they are reported, as
tests/test_minimizer_pallas.py does). Every step is integer arithmetic.
"""
import numpy as np
import pytest
import torch

from hulk_tpu.ops.encode import pack_reads
from hulk_tpu.ops.minimizer import minimizer_window
from hulk_tpu.ops.minimizer_pallas import minimizer_window_pallas
from hulk_tpu_torch.ops import minimizer as tm
from hulk_tpu_torch.synth import kernel_batch


def make_batch(rng, r, l, k, w, kind):
    lo = w + k - 1 if kind != "ragged" else 1
    seqs = []
    for i in range(r):
        n = int(rng.integers(min(lo, l), l + 1))
        if kind == "symmetric" or (kind == "mixed" and i % 3 == 1):
            s = bytearray((b"AT" * (n // 2 + 1))[:n])
            for _ in range(int(rng.integers(0, 6))):
                s[int(rng.integers(n))] = int(rng.choice(list(b"ACGTN")))
            seqs.append(bytes(s))
        else:
            nf = 0.3 if kind == "nrich" or (kind == "mixed" and i % 3 == 2) else 0.01
            seqs.append(bytes(rng.choice(list(b"ACGTN"), size=n,
                                         p=[(1 - nf) / 4] * 4 + [nf]).tolist()))
    return pack_reads(seqs, pad_to=l, n_reads=r + 2)  # two dead rows


def port_window(packed, k, w, rng):
    codes = packed.codes.copy()
    past = np.arange(codes.shape[1])[None, :] >= packed.lengths[:, None]
    codes[past] = rng.integers(0, 256, size=int(past.sum()), dtype=np.uint8)
    wm, rep = tm.minimizer_window(torch.from_numpy(codes),
                                  torch.from_numpy(packed.lengths), k, w)
    return wm.numpy().view(np.uint64), rep.numpy()


CASES = [
    (21, 9, 160, "mixed"), (11, 5, 96, "mixed"), (15, 30, 150, "random"),
    (5, 9, 100, "nrich"), (21, 1, 64, "random"), (2, 16, 70, "mixed"),
    (4, 3, 40, "symmetric"), (28, 9, 120, "mixed"), (29, 5, 100, "nrich"),
    (30, 2, 90, "symmetric"), (31, 9, 200, "mixed"), (7, 64, 130, "ragged"),
    (21, 9, 150, "ragged"),
]


@pytest.mark.parametrize("k,w,L,kind", CASES)
def test_matches_xla_window_at_every_lane(k, w, L, kind):
    rng = np.random.default_rng(k * 1000 + w)
    packed = make_batch(rng, 24, L, k, w, kind)
    wm_ref, rep_ref = minimizer_window(packed.codes, packed.lengths, k=k, w=w)
    wm, rep = port_window(packed, k, w, rng)
    assert np.array_equal(rep, np.asarray(rep_ref))
    assert np.array_equal(wm, np.asarray(wm_ref))


@pytest.mark.parametrize("k,w,L,kind", [(21, 9, 128, "mixed"), (31, 9, 100, "symmetric"),
                                        (5, 20, 200, "nrich")])
def test_matches_pallas_interpret(k, w, L, kind):
    rng = np.random.default_rng(7 + k)
    packed = make_batch(rng, 14, L, k, w, kind)
    wm_ref, rep_ref = minimizer_window_pallas(
        packed.codes, packed.lengths, k=k, w=w, block_rows=8, interpret=True)
    rep_ref = np.asarray(rep_ref)
    wm, rep = port_window(packed, k, w, rng)
    assert np.array_equal(rep, rep_ref)
    assert np.array_equal(wm[rep], np.asarray(wm_ref)[rep_ref])


def test_reported_values_below_value_bits():
    """Every reported value is < 2^(2k+8): the fused step's sort keys rely
    on it to pack read ids above the value."""
    rng = np.random.default_rng(3)
    for k, w in [(3, 9), (21, 9), (22, 9)]:
        packed = make_batch(rng, 20, 120, k, w, "mixed")
        wm, rep = port_window(packed, k, w, rng)
        assert (wm[rep] < np.uint64(1 << (2 * k + 8))).all()


def test_rejects_bad_k_w():
    c = torch.zeros((1, 8), dtype=torch.uint8)
    ln = torch.zeros(1, dtype=torch.int32)
    for k, w in [(0, 9), (32, 9), (21, 0), (21, 257)]:
        with pytest.raises(ValueError):
            tm.minimizer_window(c, ln, k, w)


def test_cuda_wrapper_refuses_cpu_tensors():
    from hulk_tpu_torch.ops.minimizer_cuda import minimizer_window_cuda

    with pytest.raises(ValueError):
        minimizer_window_cuda(torch.zeros((2, 8), dtype=torch.uint8),
                              torch.zeros(2, dtype=torch.int32), 3, 2)


def packed_batch(rng, r, l, n_dense_rows=4):
    """A v2 transfer buffer of r reads padded to l (synth.kernel_batch):
    ragged lengths, 1% N, a few N-dense rows and one all-N row, random pad
    bits past each read's length. Returns (codes2, mask8, lengths)."""
    nf = np.full((r, 1), 0.01)
    nf[2:2 + n_dense_rows] = 0.5
    nf[2 + n_dense_rows] = 1.0
    _, lengths, codes2, mask8 = kernel_batch(rng, r, l, 1, l, n_frac=nf)
    return codes2, mask8, lengths


@pytest.mark.parametrize("k", [3, 21, 31])
@pytest.mark.parametrize("w", [2, 9, 64])
def test_packed_matches_xla_window_of_unpacked(k, w):
    """The packed entry's plain version (minimizer_window_packed_torch, the
    CPU side of the device step's main path) against the reference's
    minimizer_window of its own unpack_codes2 of the same buffer."""
    import jax.numpy as jnp

    from hulk_tpu.ops.device_step import unpack_codes2 as unpack_ref

    rng = np.random.default_rng(100 * k + w)
    c2, m8, ln = packed_batch(rng, 24, 200)
    ref_codes = np.asarray(unpack_ref(jnp.asarray(c2), jnp.asarray(m8), jnp.asarray(ln)))
    wm_ref, rep_ref = minimizer_window(ref_codes, ln, k=k, w=w)
    wm, rep = tm.minimizer_window_packed(torch.from_numpy(c2), torch.from_numpy(m8),
                                         torch.from_numpy(ln), k, w)
    assert rep.numpy().any()
    assert np.array_equal(rep.numpy(), np.asarray(rep_ref))
    assert np.array_equal(wm.numpy().view(np.uint64), np.asarray(wm_ref))


def test_packed_cuda_wrapper_refuses_cpu_tensors():
    from hulk_tpu_torch.ops.minimizer_cuda import minimizer_window_packed_cuda

    with pytest.raises(ValueError):
        minimizer_window_packed_cuda(torch.zeros((2, 2), dtype=torch.uint8),
                                     torch.zeros((2, 1), dtype=torch.uint8),
                                     torch.zeros(2, dtype=torch.int32), 3, 2)
