"""The secondary sketches (KMV, KHF, HyperMinHash) against hulk_tpu on the
CPU: the device updates (ops/device_sketches.py) against
hulk_tpu.ops.device_sketches on full-range u64 values, the fused step's
bottom-k feed against hulk_tpu's bottom_k_values, the group step's states
against hulk_tpu's group step, and `sketch --kmv --khf --hmh` end to end
(alone, with -i, with -x). The port's sketch/minhash.py is a copy of
hulk_tpu's; its serialised sketches are compared through out.json.

Tolerance: bit-equality (integer arithmetic wrapping mod 2^64),
byte-identical out.json.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hulk_tpu.cli as jax_cli
import hulk_tpu_torch.cli as torch_cli
from hulk_tpu.ops import device_sketches as jsk
from hulk_tpu.ops import device_step as jds
from hulk_tpu_torch import native
from hulk_tpu_torch.ops import device_sketches as tsk
from hulk_tpu_torch.ops import device_step as tds
from hulk_tpu_torch.sketch.hyperminhash import DEFAULT_P, DEFAULT_Q, DEFAULT_R
from hulk_tpu_torch.synth import generate

U64MAX = np.uint64(2**64 - 1)


def full_range(rng, n, dead=0.2):
    """u64 values over the whole range (about half above 2^63), a share of
    dead lanes (the sentinel) and a few duplicates."""
    v = rng.integers(0, 2**64 - 1, size=n, dtype=np.uint64)
    v[rng.random(n) < dead] = U64MAX
    if n >= 20:
        v[:8] = v[8:16]
        v[16:20] = [0, 1, 2**63, 2**64 - 2]
    return v


def t64(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64))


@pytest.mark.parametrize("n", [0, 1, 37, 5000])
@pytest.mark.parametrize("s", [1, 8, 42])
def test_khf_update_matches_reference(s, n):
    rng = np.random.default_rng(s * 7919 + n)
    vals = full_range(rng, n)
    state = full_range(rng, s, dead=0.5)
    got = tsk.khf_update(t64(state), t64(vals)).numpy().view(np.uint64)
    # hulk_tpu's min over an empty batch has no identity: the state stands
    want = np.asarray(jsk.khf_update(jnp.asarray(state), jnp.asarray(vals))) if n else state
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n", [0, 1, 5000])
def test_hmh_update_matches_reference(n):
    rng = np.random.default_rng(n + 3)
    vals = full_range(rng, n)
    regs = np.zeros(1 << DEFAULT_P, dtype=np.uint64)
    regs[::7] = rng.integers(0, 1 << 22, size=regs[::7].size, dtype=np.uint64)
    got = tsk.hmh_update(t64(regs), t64(vals)).numpy().view(np.uint64)
    want = np.asarray(jsk.hmh_update(jnp.asarray(regs), jnp.asarray(vals),
                                     p=DEFAULT_P, q=DEFAULT_Q, r=DEFAULT_R))
    assert np.array_equal(got, want)
    assert (got != regs).any() == (n > 0)


@pytest.mark.parametrize("k", [28, 31])
def test_kmv_update_matches_reference(k):
    """KMV takes the first s of a batch in unsigned order: values that
    reach bit 63 (k >= 28: 2k + 8 >= 64) must sort after smaller ones."""
    rng = np.random.default_rng(k)
    s = 20
    hi = 2 ** min(2 * k + 8, 64) - 1
    vals = rng.integers(0, hi, size=400, dtype=np.uint64, endpoint=True)
    vals[::5] = U64MAX
    svals = np.sort(vals)
    state = np.sort(rng.integers(0, hi, size=s, dtype=np.uint64, endpoint=True))
    state[s // 2:] = U64MAX
    got = tsk.kmv_update(t64(state), t64(svals)).numpy().view(np.uint64)
    want = np.asarray(jsk.kmv_update(jnp.asarray(state), jnp.asarray(svals)))
    assert np.array_equal(got, want)
    # a signed merge would take the values at and above 2^63 first
    signed = np.sort(np.concatenate([state, svals[:s]]).view(np.int64))[:s]
    assert not np.array_equal(signed.view(np.uint64), got)


@pytest.mark.parametrize("n,s", [(1000, 42), (10, 42), (0, 5)])
def test_bottom_k_values_matches_reference(n, s):
    rng = np.random.default_rng(n + s)
    vals = rng.integers(0, 2**62, size=n, dtype=np.uint64)
    vals[rng.random(n) < 0.3] = U64MAX
    got = tds.bottom_k_values(t64(vals), s).numpy().view(np.uint64)
    pad = np.concatenate([vals, np.full(max(0, s - n), U64MAX, dtype=np.uint64)])
    want = np.asarray(jds.bottom_k_values(jnp.asarray(pad), s))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("g,r,l,k,w", [(3, 64, 160, 11, 5), (2, 2112, 64, 22, 9)])
def test_group_step_sketches_match_reference(g, r, l, k, w):
    """The fused step's feed (live distinct prefix, read-grouped) gives the
    states hulk_tpu's group step carries (fed its full R*L stream)."""
    s = 24
    rng = np.random.default_rng(g + r + k)
    pairs = [(rng.choice(5, size=(r, l), p=[0.245] * 4 + [0.02]).astype(np.uint8),
              rng.integers(k + w, l + 1, size=r).astype(np.int32)) for _ in range(g)]
    flat = native.pack_group2(pairs, g, r, l)
    bucket = tds.stream_bucket(r, r * l, l=l, k=k, w=w)
    nbins = 20_000
    hist = torch.zeros(nbins, dtype=torch.int32)
    count = torch.zeros((), dtype=torch.int64)
    st = tsk.SketchStates.empty(s, kmv=True, khf=True, hmh=True, device="cpu")
    tds.group_scan_body(hist, count, torch.from_numpy(flat), g=g, r=r, l=l, k=k, w=w,
                        bucket=bucket, states=st)
    h, c, kmv, khf, hmh = jds.sketch_stream_group_step(
        jnp.zeros(nbins, dtype=jnp.int32), jnp.zeros((), dtype=jnp.int64),
        jnp.full(s, U64MAX, dtype=jnp.uint64), jnp.full(s, U64MAX, dtype=jnp.uint64),
        jnp.zeros(1 << DEFAULT_P, dtype=jnp.uint64), jnp.asarray(flat),
        g=g, r=r, l=l, k=k, w=w, bucket=bucket, use_kmv=True, use_khf=True,
        use_hmh=True, hmh_pqr=(DEFAULT_P, DEFAULT_Q, DEFAULT_R), packed2=True,
        compact=True)
    assert int(count) == int(c) > 0
    assert np.array_equal(hist.numpy(), np.asarray(h))
    for got, want in ((st.kmv, kmv), (st.khf, khf), (st.hmh, hmh)):
        assert np.array_equal(got.numpy().view(np.uint64), np.asarray(want))


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("reads")
    return generate(str(d / "reads.fq.gz"), 3000, read_len=150, seed=12)


@pytest.mark.parametrize("extra", [[], ["-i", "700"], ["-i", "1000", "-x", "0.9", "-s", "42"]])
def test_out_json_byte_identical_with_sketches(reads, tmp_path, monkeypatch, extra):
    monkeypatch.setenv("HULK_TPU_TORCH_CACHE", str(tmp_path / "cache"))
    args = ["sketch", "-f", reads, "-k", "11", "-w", "5", "--kmv", "--khf", "--hmh", *extra]
    assert jax_cli.main(args + ["-o", str(tmp_path / "jax")]) == 0
    assert torch_cli.main(args + ["-o", str(tmp_path / "port"), "--device", "cpu"]) == 0
    want = (tmp_path / "jax.json").read_bytes()
    assert (tmp_path / "port.json").read_bytes() == want
    for algo in (b'"kmv"', b'"khf"', b'"hyperminhash"'):
        assert algo in want
