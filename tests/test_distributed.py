"""Multi-host clip decode (SURVEY.md §5 distributed backend): two real
processes join a jax.distributed coordinator, form a global 2x4-device CPU
mesh, decode a shared synthetic clip on it, reduce across hosts, and export
disjoint DNG shards (the standard JAX multi-process recipe — the identical
code path drives multi-host GPU clusters)."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_global_mesh(tmp_path):
    port = _free_port()
    outdir = str(tmp_path / "dng")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(ROOT)
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [
                sys.executable,
                str(ROOT / "tests" / "_distributed_worker.py"),
                str(port),
                str(pid),
                outdir,
            ],
            cwd=ROOT,
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-3000:]}"
        assert f"WORKER-OK {pid}" in out
    # The two hosts wrote disjoint halves of one globally-numbered sequence.
    names = sorted(os.listdir(outdir))
    assert names == [f"frame_{i:06d}.dng" for i in range(8)]
