"""`-p` as the team of every OpenMP pass of the native runtime, in whichever
thread the pass runs, as GOMAXPROCS bounds the reference's whole process
(hulk v1.0.0 cmd/sketch.go:198-201). The parse runs on `hulk-parse`, the
group pack on the stream thread: an OpenMP count set in the thread that
parses the flags would not reach them. The parallel parse's slices follow
the same count, and its rows stay where the serial parser puts them."""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from hulk_tpu_torch import native, spans

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(not native.available(), reason="native runtime not built")


def _fastq(n: int, seed: int, crlf: bool = False) -> bytes:
    """n FASTQ records of 1-300 bases with N, every third line ending in
    CRLF when asked."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        seq = bytes(rng.choice(list(b"ACGTN"), size=int(rng.integers(1, 300))).astype(np.uint8))
        lines += [b"@r%d" % i, seq, b"+", b"I" * len(seq)]
    eol = [b"\r\n" if crlf and j % 3 == 0 else b"\n" for j in range(len(lines))]
    return b"".join(line + e for line, e in zip(lines, eol))


@pytest.fixture
def restore_threads():
    yield
    native.set_threads(os.cpu_count() or 1)


def test_every_parallel_region_takes_its_team_from_p():
    src = open(os.path.join(ROOT, "hulk_tpu_torch", "native", "hulkrt.cpp")).read()
    regions = re.findall(r"#pragma omp parallel[^\n]*", src)
    assert len(regions) == 9
    for r in regions:
        assert re.search(r"num_threads\((hulk_team\(\)|S)\)", r), r
    assert "omp_set_num_threads(" not in src
    reads = [line for line in src.splitlines()
             if "omp_get_max_threads()" in line and "static inline" not in line]
    assert len(reads) == 1 and "g_threads{" in reads[0], reads  # the default alone


_IN_A_THREAD = r"""
import json, threading
import numpy as np
from hulk_tpu_torch import native, spans

buf = np.frombuffer(open(SRC, "rb").read(), dtype=np.uint8)
lib = native._load()
spans.enable(True)
got = {}

def work(p):
    spans.reset()
    packer = native.NativeFastqPacker(cap_reads=4096, cap_len=65536)
    (codes, lengths), = packer._feed_par(buf)
    counts = spans.counters()
    rows = min(codes.shape[0], 2048)
    out = np.empty(native.group2_nbytes(1, 2048, 320), dtype=np.uint8)
    lengths = np.ascontiguousarray(lengths[:rows])
    pack = lib.hulk_pack_group_batch2(
        native._ptr(np.ascontiguousarray(codes[:rows])), rows, codes.shape[1],
        native._ptr(lengths), 2048, 320, native._ptr(out),
        native._ptr(out[2048 * 80:]), native._ptr(out[2048 * 120:]))
    got[p] = [counts["input.parse_par_calls"], counts["input.parse_team_threads"], pack]

for p in (3, 1):
    native.set_threads(p)
    t = threading.Thread(target=work, args=(p,), name="hulk-parse")
    t.start()
    t.join(60)
    assert not t.is_alive()
print(json.dumps(got))
"""


def test_p_reaches_a_thread_other_than_the_flag_parser(tmp_path):
    """With OMP_NUM_THREADS unset, a parallel parse and a group pack started
    from a new thread run with the team the main thread set."""
    src = tmp_path / "reads.fq"
    src.write_bytes(_fastq(3_000, 1))
    env = {k: v for k, v in os.environ.items() if not k.startswith(("OMP_", "GOMP_"))}
    env["PYTHONPATH"] = os.pathsep.join([ROOT, env.get("PYTHONPATH", "")])
    done = subprocess.run(
        [sys.executable, "-c", f"SRC = {str(src)!r}\n" + _IN_A_THREAD],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    got = json.loads(done.stdout.strip().splitlines()[-1])
    assert got == {"3": [1, 3, 3], "1": [1, 1, 1]}


@pytest.mark.parametrize("threads", [1, 3, 8])
def test_the_parse_slices_follow_p(threads, restore_threads):
    """Rows byte-equal to the serial parser's at each team, on CRLF lines
    and a buffer that ends inside a record (its sequence line last), so the
    phase carries into the next feed."""
    data = _fastq(2_500, 7, crlf=True)
    data += b"@odd\r\nACGTNNACG\r\n"
    native.set_threads(threads)

    def parse(par: bool):
        packer = native.NativeFastqPacker(cap_reads=1024, cap_len=65536)
        buf = np.frombuffer(data, dtype=np.uint8)
        items = packer._feed_par(buf) if par else packer._feed_serial_buf(buf)
        assert all(isinstance(x, tuple) for x in items)
        lengths = np.concatenate([ln for _, ln in items])
        rows = [c[i, :ln[i]].tobytes() for c, ln in items for i in range(ln.shape[0])]
        return lengths, rows, int(packer.phase[0])

    spans.enable(True)
    spans.reset()
    try:
        par = parse(True)
        counts = spans.counters()
    finally:
        spans.enable(False)
        spans.reset()
    serial = parse(False)
    assert par[2] == serial[2] == 2
    np.testing.assert_array_equal(par[0], serial[0])
    assert par[1] == serial[1]
    assert par[0].shape[0] == 2_501 and par[0][-1] == 9
    assert counts == {"input.parse_par_calls": 1, "input.parse_team_threads": threads}
