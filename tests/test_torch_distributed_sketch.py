"""`sketch` over several processes (cli.run_sketch's file shard,
stream/pipeline.py's exact merge): OS processes of the port on this machine
(--device cpu), one gloo group, each rank with a time limit, against one
process of the port and of hulk_tpu. Tolerance: byte-identical out.json.
"""
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest

import hulk_tpu.cli as jax_cli
import hulk_tpu.stream.pipeline as jax_pipeline
import hulk_tpu_torch.cli as torch_cli
from hulk_tpu_torch.parallel import distributed as dist
from hulk_tpu_torch.stream.pipeline import PipelineError, SketchConfig, run_sketch_pipeline
from hulk_tpu_torch.synth import generate

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 180  # seconds a rank may take before the test fails
FLAGS = ["-k", "11", "-w", "5", "-s", "8"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(argv, n: int, cwd, stdin_path=None) -> list:
    """Start n processes, rank r running argv(r), as one group, with stdin
    from stdin_path (or nothing); each must end within RANK_TIMEOUT (all
    are killed otherwise). Returns (rc, output) of each."""
    port = _free_port()
    env = dict(os.environ, HULK_COORDINATOR=f"127.0.0.1:{port}", HULK_NUM_PROCS=str(n))
    env["PYTHONPATH"] = REPO_ROOT + (os.pathsep + env["PYTHONPATH"]
                                     if env.get("PYTHONPATH") else "")
    ins = [open(stdin_path, "rb") if stdin_path else subprocess.DEVNULL for _ in range(n)]
    procs = [subprocess.Popen([sys.executable, *argv(r)], env=dict(env, HULK_PROC_ID=str(r)),
                              cwd=cwd, stdin=ins[r], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(n)]
    try:
        outs = [p.communicate(timeout=RANK_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
        for f in ins:
            if f is not subprocess.DEVNULL:
                f.close()
    return [(p.returncode, o.decode(errors="replace")) for p, o in zip(procs, outs)]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_sketch")
    return [generate(str(d / "a.fq.gz"), 700, read_len=150, seed=31),
            generate(str(d / "b.fq.gz"), 900, read_len=150, seed=32)]


def _sketch_argv(src: str, out, log):
    return ["-m", "hulk_tpu_torch", "sketch", "-f", src, *FLAGS, "-o", str(out),
            "--device", "cpu", "--log", str(log)]


def _one_process(src: str, tmp_path, extra=()) -> tuple[bytes, bytes]:
    """out.json of one process of the port and of hulk_tpu."""
    for main, tag in ((torch_cli.main, "one"), (jax_cli.main, "jax")):
        argv = ["sketch", "-f", src, *FLAGS, *extra, "-o", str(tmp_path / tag), "--log",
                str(tmp_path / f"{tag}.log")]
        assert main(argv + (["--device", "cpu"] if tag == "one" else [])) == 0
    return (tmp_path / "one.json").read_bytes(), (tmp_path / "jax.json").read_bytes()


def test_two_ranks_byte_identical(files, tmp_path, monkeypatch):
    """Two ranks, a file each, --kmv --khf --hmh: rank 0 writes out.json,
    byte-identical to one process's (the port's and hulk_tpu's); rank 1
    writes nothing and says so."""
    monkeypatch.setenv("HULK_TPU_TORCH_CACHE", str(tmp_path / "cache"))
    src = ",".join(files)
    extra = ["--kmv", "--khf", "--hmh"]
    logs = [tmp_path / f"rank{r}.log" for r in range(2)]
    for rc, text in run_ranks(lambda r: [*_sketch_argv(src, tmp_path / "ranks", logs[r]),
                                         *extra], 2, tmp_path):
        assert rc == 0, text[-3000:]
    one, ref = _one_process(src, tmp_path, extra)
    assert one == ref
    assert (tmp_path / "ranks.json").read_bytes() == one
    texts = [p.read_text() for p in logs]
    for r in range(2):
        assert f"multi-host: process {r}/2 takes 1 of 2 files" in texts[r]
        assert "merging 2 process shards" in texts[r]
    assert "written sketch to disk" in texts[0]
    assert "output written by process 0" in texts[1]
    assert "written sketch to disk" not in texts[1]


def test_rank_without_files_never_reads_stdin(files, tmp_path, monkeypatch):
    """Three ranks over two files: rank 2 has none. Each rank's stdin holds
    reads that are not in the files; the output is still one process's
    over the two files, so rank 2 took part in the merge without reading
    them."""
    monkeypatch.setenv("HULK_TPU_TORCH_CACHE", str(tmp_path / "cache"))
    stdin = generate(str(tmp_path / "stdin.fq"), 300, read_len=150, seed=33)
    src = ",".join(files)
    logs = [tmp_path / f"rank{r}.log" for r in range(3)]
    for rc, text in run_ranks(lambda r: _sketch_argv(src, tmp_path / "ranks", logs[r]), 3,
                              tmp_path, stdin_path=stdin):
        assert rc == 0, text[-3000:]
    assert "process 2/3 takes 0 of 2 files" in logs[2].read_text()
    assert "processed 1600 sequences in total" in logs[2].read_text()
    one, ref = _one_process(src, tmp_path)
    assert one == ref
    assert (tmp_path / "ranks.json").read_bytes() == one


# hulk_tpu's messages (pipeline.py:511-545, cli.py:201)
REFUSALS = {
    "interval": (["-i", "500"], "interval flushing requires a single process"),
    "checkpoint": (["--checkpoint", "ck.npz"],
                   "checkpoint/resume requires a single process"),
    "deviceFlush": (["--deviceFlush"], "device flush requires a single process"),
    "stdin": (None, "multi-host runs require file inputs (no STDIN)"),
}


@pytest.mark.parametrize("what", list(REFUSALS))
def test_refusals_on_every_rank(files, tmp_path, what):
    """What hulk_tpu refuses with more than one process fails every rank
    with its message, and nothing is written."""
    extra, msg = REFUSALS[what]
    stdin = None
    if extra is None:
        stdin = generate(str(tmp_path / "stdin.fq"), 50, read_len=150, seed=34)

    def argv(r):
        a = ["-m", "hulk_tpu_torch", "sketch", *FLAGS, "-o", str(tmp_path / "ranks"),
             "--device", "cpu"]
        return a if extra is None else [*a, "-f", ",".join(files), *extra]

    for rc, text in run_ranks(argv, 2, tmp_path, stdin_path=stdin):
        assert rc == 1, text[-3000:]
        assert msg in text
    assert not (tmp_path / "ranks.json").exists()


@pytest.mark.parametrize("field,value", [("interval", 500), ("checkpoint_path", "ck.npz"),
                                         ("device_flush", True)])
def test_refusal_messages_equal_reference(files, monkeypatch, field, value):
    """In-process, with a world of two pretended: the port's pipeline and
    hulk_tpu's (jax.process_count() of 2) raise the same message."""
    kw = {field: value}
    monkeypatch.setattr(dist, "world_size", lambda: 2)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    with pytest.raises(PipelineError) as got:
        run_sketch_pipeline(None, SketchConfig(device="cpu", input_paths=files, **kw))
    with pytest.raises(jax_pipeline.PipelineError) as want:
        jax_pipeline.run_sketch_pipeline(None, jax_pipeline.SketchConfig(
            input_paths=files, device_stream=True, **kw))
    assert str(got.value) == str(want.value)


def test_merge_of_one_process_is_identity(files, monkeypatch):
    """The cross-process merge in a world of one (the helpers' one-process
    forms): the same out.json as without it."""
    from hulk_tpu_torch.stream import pipeline

    cfg = dict(device="cpu", input_paths=files, kmer_size=11, window_size=5, sketch_size=8,
               kmv=True, khf=True, hmh=True)
    want = run_sketch_pipeline(None, SketchConfig(**cfg))
    calls = []
    merge = pipeline._merge_processes

    def spy(*a):
        calls.append(True)
        return merge(*a)

    monkeypatch.setattr(pipeline, "_merge_processes", spy)
    monkeypatch.setattr(dist, "world_size", lambda: 2)
    monkeypatch.setattr(dist, "allgather", lambda x: np.ascontiguousarray(x)[None].copy())
    got = run_sketch_pipeline(None, SketchConfig(**cfg))
    assert calls == [True]
    assert got.hulk_data.to_json_bytes() == want.hulk_data.to_json_bytes()
    assert (got.seq_count, got.minimizer_count) == (want.seq_count, want.minimizer_count)
