"""The port's copy of the native parsers (hulk_tpu_torch/native): the pad of
a record that the long-record loop emits as a short row, and the length
test of a CRLF line, which must not count the CR.

A record that reaches the Python long-record loop but fits under the
stride cap comes out as a one-row pair whose bytes past its length are the
pad code 5. A read of cap_len - 1 bases takes the batched path whether its
lines end in LF or CRLF, beside a read past the cap that sends the buffer
through the long-record split; the two files give byte-identical out.json.
Tolerance: none.
"""
import numpy as np
import pytest

import hulk_tpu_torch.cli as torch_cli
from hulk_tpu_torch import native
from hulk_tpu_torch.ops.encode import PAD_CODE, encode_seq
from hulk_tpu_torch.stream.fastq import LongRead, batch_reads_native

needs_native = pytest.mark.skipif(not native.available(), reason="native runtime unavailable")


def bases(rng, n: int) -> bytes:
    return bytes(rng.choice(list(b"ACGT"), size=n).tolist())


def fastq(seqs, eol: bytes = b"\n") -> bytes:
    return b"".join(b"@r%d" % i + eol + s + eol + b"+" + eol + b"I" * len(s) + eol
                    for i, s in enumerate(seqs))


def paths(items) -> list:
    """("long", length) for a LongSeq, ("norm", length) for each row of a
    pair, in stream order."""
    out = []
    for it in items:
        if isinstance(it, native.LongSeq):
            out.append(("long", int(it.codes.shape[0])))
        else:
            out.extend(("norm", int(n)) for n in it[1])
    return out


@needs_native
@pytest.mark.parametrize("cut", [60, 100, 150])
def test_short_record_from_long_loop_is_padded_with_5(cut):
    """The first record straddles the two feeds, the long one follows in the
    second: the long-record loop starts on the carried short record and
    emits it as a one-row pair."""
    rng = np.random.default_rng(cut)
    recs = [bases(rng, 200), bases(rng, 1000), bases(rng, 80)]
    data = b"".join(b">r%d\n" % i + b"\n".join(r[j:j + 50] for j in range(0, len(r), 50))
                    + b"\n" for i, r in enumerate(recs))
    p = native.NativeFastaPacker(cap_reads=64, cap_len=256)
    items = p.feed(data[:cut]) + p.feed(data[cut:]) + p.end_of_file()
    assert paths(items) == [("norm", 200), ("long", 1000), ("norm", 80)]
    codes, lengths = items[0]
    assert codes.shape == (1, 256)
    np.testing.assert_array_equal(codes[0, :200], encode_seq(recs[0]))
    assert (codes[0, int(lengths[0]):] == PAD_CODE).all()


@needs_native
@pytest.mark.parametrize("cap", [128, 256])
def test_crlf_read_below_cap_stays_batched(cap):
    rng = np.random.default_rng(cap)
    seqs = [bases(rng, cap - 1), bases(rng, 3 * cap), bases(rng, 50), bases(rng, cap)]
    want = [("norm", cap - 1), ("long", 3 * cap), ("norm", 50), ("long", cap)]
    for eol in (b"\n", b"\r\n"):
        p = native.NativeFastqPacker(cap_reads=64, cap_len=cap)
        assert paths(p.feed(fastq(seqs, eol)) + p.end_of_file()) == want, eol


@needs_native
def test_crlf_and_lf_files_take_one_path_and_give_one_out_json(tmp_path, monkeypatch):
    """At the default cap of 65,536 bases: the same batches and long reads
    from both files, and the same out.json."""
    monkeypatch.setenv("HULK_TPU_TORCH_CACHE", str(tmp_path / "cache"))
    rng = np.random.default_rng(7)
    seqs = [bases(rng, 150), bases(rng, 65_535), bases(rng, 70_000), bases(rng, 120)]
    outs, shapes = [], []
    for name, eol in (("lf", b"\n"), ("crlf", b"\r\n")):
        # the same relative file name: out.json names its input
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        with open("reads.fq", "wb") as fh:
            fh.write(fastq(seqs, eol))
        shapes.append([("long", b.codes.shape[0]) if isinstance(b, LongRead)
                       else ("batch", b.lengths.tolist())
                       for b in batch_reads_native(["reads.fq"], batch_size=64)])
        assert torch_cli.main(["sketch", "-f", "reads.fq", "-k", "21", "-s", "8", "-o", "out",
                               "--device", "cpu"]) == 0
        outs.append((tmp_path / name / "out.json").read_bytes())
    assert shapes[0] == shapes[1]
    assert ("long", 70_000) in shapes[0] and all(s[0] == "batch" or s[1] != 65_535
                                                 for s in shapes[0])
    assert outs[0] == outs[1]
