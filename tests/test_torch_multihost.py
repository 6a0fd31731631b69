"""Two processes joined into one gloo world on the CPU (the port's
multi-host runtime): each runs the sharded chunk step of
rawhash_tpu_torch/parallel/multihost.py --selftest and holds the gathered
outputs bit for bit against the single-process step."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("n_shards", [1, 2])
def test_two_process_selftest(n_shards):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "rawhash_tpu_torch.parallel.multihost",
             "--coordinator", f"localhost:{port}", "--num-processes", "2",
             "--process-id", str(i), "--n-shards", str(n_shards), "--selftest",
             "--device", "cpu"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (out, err) in enumerate(outs):
        assert procs[i].returncode == 0, f"process {i}\n{out}\n{err[-2000:]}"
        assert f"MULTIHOST_OK process={i}" in out, (out, err[-2000:])
