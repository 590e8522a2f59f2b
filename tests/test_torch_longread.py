"""Long reads and FASTA against hulk_tpu on the CPU: the cont form of the
window (ops/minimizer.py), the long-read scan (ops/longread.py) against
hulk_tpu.ops.longread and against a scan of the read in one piece, and
`sketch` end to end on FASTA (short records; contigs past the top length
bucket of 65,536 bases) and on FASTQ reads past 65,536 bases: with and
without -i, at k = 31 with the three sketches, with --stream, killed at a
checkpoint between two long records and resumed, and sharded over three
CPU devices. Long records go to the device stream's carries, never to the
host spectrum or sketch objects.

Tolerance: bit-equality of the distinct values; byte-identical out.json
and stdout.
"""
import io
import sys

import numpy as np
import pytest
import torch

import hulk_tpu.cli as jax_cli
import hulk_tpu_torch.cli as torch_cli
from hulk_tpu_torch.sketch import hyperminhash, minhash, spectrum
from hulk_tpu.ops.longread import long_read_minimizers as jax_long_read
from hulk_tpu.ops.minimizer import minimizer_window as jax_window
from hulk_tpu_torch.ops import minimizer as tm
from hulk_tpu_torch.ops.longread import long_read_minimizers
from hulk_tpu_torch.synth import generate_fasta, generate_mixed, kernel_batch


def read_codes(rng, n, n_frac=0.01):
    return np.where(rng.random(n) < n_frac, 4, rng.integers(0, 4, size=n)).astype(np.uint8)


@pytest.mark.parametrize("k,w", [(21, 9), (31, 2), (5, 64), (3, 20)])
def test_cont_window_matches_reference(k, w):
    codes, lengths, _, _ = kernel_batch(np.random.default_rng(k * w), 8, 400, 1, 400)
    ref_codes = np.where(np.arange(400) < lengths[:, None], codes, 5)
    wm_ref, rep_ref = jax_window(ref_codes, lengths, k=k, w=w, cont=True)
    wm, rep = tm.minimizer_window(torch.from_numpy(codes), torch.from_numpy(lengths), k, w,
                                  cont=True)
    rep_ref = np.asarray(rep_ref)
    assert rep_ref.any() and not rep_ref[:, :w + k - 1].any()
    assert np.array_equal(rep.numpy(), rep_ref)
    assert np.array_equal(wm.numpy().view(np.uint64)[rep_ref], np.asarray(wm_ref)[rep_ref])


@pytest.mark.parametrize("k,w,L,block,group", [
    (21, 9, 300_000, 4096, 4), (31, 2, 120_000, 2048, 3), (5, 64, 50_000, 1024, 16),
    (11, 5, 3000, 4096, 4), (15, 1, 40_000, 512, 8),
])
def test_long_read_minimizers_match_reference(k, w, L, block, group):
    codes = read_codes(np.random.default_rng(L + k), L)
    got = long_read_minimizers(codes, k=k, w=w, cap=block, device="cpu")
    want = jax_long_read(codes, k=k, w=w, block=block, group=group)
    assert got.dtype == np.uint64 and got.size > 0
    assert np.array_equal(got, want)


@pytest.mark.parametrize("k,w", [(21, 9), (31, 4)])
def test_long_read_minimizers_match_one_piece(k, w):
    """Blocks with halos give the distinct set of the read in one piece."""
    L = 20_000
    codes = read_codes(np.random.default_rng(k), L, n_frac=0.05)
    vals, mask = tm.minimizer_scan(torch.from_numpy(codes[None, :]),
                                   torch.tensor([L], dtype=torch.int32), k, w)
    whole = np.sort(vals[mask].numpy().view(np.uint64))
    got = long_read_minimizers(codes, k=k, w=w, cap=1500, device="cpu")
    assert np.array_equal(got, whole)


def test_long_read_shorter_than_window_raises():
    with pytest.raises(ValueError, match="w \\+ k - 1"):
        long_read_minimizers(np.zeros(10, dtype=np.uint8), k=11, w=5, device="cpu")


def contig_file(path):
    """Short records (100-150 bp) around three contigs of 70-130 kb."""
    generate_fasta(str(path) + ".long", 3, lo=70_000, hi=130_000, seed=3)
    generate_fasta(str(path) + ".short", 30, lo=100, hi=150, seed=4)
    long_ = open(str(path) + ".long", "rb").read().split(b">")[1:]
    short = open(str(path) + ".short", "rb").read().split(b">")[1:]
    recs = short[:10] + long_[:2] + short[10:20] + long_[2:] + short[20:]
    path.write_bytes(b"".join(b">" + r for r in recs))
    return str(path)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("inputs")
    return {
        "contigs": contig_file(d / "contigs.fa"),
        "records": generate_fasta(str(d / "records.fa.gz"), 300, lo=100, hi=2000, seed=4),
        "long_fastq": generate_mixed(str(d / "long.fq"), 5, lo=50_000, hi=140_000, seed=6),
    }


@pytest.mark.parametrize("name,extra", [
    ("records", ["--fasta"]), ("records", ["--fasta", "-i", "100"]),
    ("contigs", ["--fasta"]), ("contigs", ["--fasta", "-i", "11", "--kmv", "--khf", "--hmh"]),
    ("long_fastq", ["--kmv", "--hmh"]),
    ("contigs", ["--fasta", "-k", "31", "-s", "8", "--kmv", "--khf", "--hmh"]),
    ("long_fastq", ["-k", "31", "-s", "8", "--kmv", "--khf", "--hmh"]),
])
def test_out_json_byte_identical(inputs, tmp_path, monkeypatch, name, extra):
    monkeypatch.setenv("HULK_TPU_TORCH_CACHE", str(tmp_path / "cache"))
    args = ["sketch", "-f", inputs[name], "-k", "11", "-w", "5", *extra]
    assert jax_cli.main(args + ["-o", str(tmp_path / "jax")]) == 0
    assert torch_cli.main(args + ["-o", str(tmp_path / "port"), "--device", "cpu"]) == 0
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()


def _cli(main, args) -> bytes:
    """main(args) with sys.stdout captured; returns what went to it."""
    buf = io.BytesIO()
    out, sys.stdout = sys.stdout, io.TextIOWrapper(buf)
    try:
        assert main(args) == 0
        sys.stdout.flush()
    finally:
        sys.stdout.detach()
        sys.stdout = out
    return buf.getvalue()


@pytest.mark.parametrize("extra", [["-i", "11"], ["-i", "7", "-x", "0.9", "--streamAll",
                                                  "--kmv", "--khf", "--hmh"]])
def test_stream_stdout_byte_identical(inputs, tmp_path, monkeypatch, extra):
    """--stream over the contigs: every interval's snapshot and the final
    sketch on stdout, the same bytes as hulk_tpu's."""
    monkeypatch.setenv("HULK_TPU_TORCH_CACHE", str(tmp_path / "cache"))
    args = ["sketch", "-f", inputs["contigs"], "--fasta", "-k", "11", "-w", "5", "-s", "8",
            "--stream", *extra]
    want = _cli(jax_cli.main, args + ["-o", str(tmp_path / "jax")])
    got = _cli(torch_cli.main, args + ["-o", str(tmp_path / "port"), "--device", "cpu"])
    assert got == want and got.count(b'"histosketch"') > 3
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()


def test_resume_between_long_records(tmp_path, monkeypatch):
    """A run killed after the checkpoint that lies between two long records
    (records 4 and 5 of 8, -i 2) and resumed over the whole file writes
    hulk_tpu's out.json of the whole file. The kill is built, as hulk_tpu's
    tests build it, by a run over the first four records."""
    monkeypatch.setenv("HULK_TPU_TORCH_CACHE", str(tmp_path / "cache"))
    rng = np.random.default_rng(41)
    lens = [300, 100_000, 200, 70_000, 90_000, 5000, 80_000, 400]
    recs = [bytes(rng.choice(list(b"ACGTN"), p=[0.2475] * 4 + [0.01], size=n).tolist())
            for n in lens]

    def write(path, rs):
        path.write_bytes(b"".join(b">c%d\n%s\n" % (i, r) for i, r in enumerate(rs)))
        return str(path)

    full, head = write(tmp_path / "all.fa", recs), write(tmp_path / "head.fa", recs[:4])
    ck = str(tmp_path / "ck.npz")
    args = ["sketch", "--fasta", "-k", "11", "-w", "5", "-s", "8", "-i", "2", "--kmv", "--khf",
            "--hmh"]
    assert jax_cli.main(args + ["-f", full, "-o", str(tmp_path / "jax")]) == 0
    assert torch_cli.main(args + ["-f", head, "-o", str(tmp_path / "head"), "--checkpoint", ck,
                                  "--device", "cpu"]) == 0
    assert int(np.load(ck)["seq_count"]) == 4
    assert torch_cli.main(args + ["-f", full, "-o", str(tmp_path / "port"), "--resume", ck,
                                  "--device", "cpu"]) == 0
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()


@pytest.mark.parametrize("extra", [[], ["-i", "11", "--kmv", "--khf", "--hmh"]])
def test_sharded_long_contigs_byte_identical(inputs, tmp_path, monkeypatch, extra):
    """--device cpu,cpu,cpu: long records go to shard 0, short ones are
    striped over the three; out.json is hulk_tpu's."""
    monkeypatch.setenv("HULK_TPU_TORCH_CACHE", str(tmp_path / "cache"))
    args = ["sketch", "-f", inputs["contigs"], "--fasta", "-k", "11", "-w", "5", *extra]
    assert jax_cli.main(args + ["-o", str(tmp_path / "jax")]) == 0
    assert torch_cli.main(args + ["-o", str(tmp_path / "port"), "--device", "cpu,cpu,cpu"]) == 0
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()


@pytest.mark.parametrize("name", ["contigs", "long_fastq"])
def test_long_reads_skip_host_objects(inputs, tmp_path, monkeypatch, name):
    """The host spectrum and sketch objects take no hashes: each long
    record is binned and sketched on the device, and reaches the host only
    through the stream's drain and merge, as short reads do."""
    monkeypatch.setenv("HULK_TPU_TORCH_CACHE", str(tmp_path / "cache"))
    calls = []

    def spy(self, hashes):
        calls.append((type(self).__name__, len(hashes)))

    for cls in (spectrum.KmerSpectrum, minhash.KMVSketch, minhash.KHFSketch,
                hyperminhash.HyperMinHash):
        monkeypatch.setattr(cls, "add_hashes", spy)
    args = ["sketch", "-f", inputs[name], "-k", "11", "-w", "5", "--kmv", "--khf", "--hmh",
            *(["--fasta"] if name == "contigs" else [])]
    assert torch_cli.main(args + ["-o", str(tmp_path / "port"), "--device", "cpu"]) == 0
    assert calls == []
    assert jax_cli.main(args + ["-o", str(tmp_path / "jax")]) == 0
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
