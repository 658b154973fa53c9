"""The port's multi-process runtime entry (parallel/multihost.py): the
single-process no-op, and a real two-process gloo group on the CPU whose
ranks join by arguments (rank 0) and by torchrun's environment (rank
1), report which is primary, and count distinct k-mers together."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from metagraph_tpu_torch.kmer.alphabets import DNA, INVALID_CODE
from metagraph_tpu_torch.parallel import multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK")

_WORKER = r"""
import json, os, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
torch.set_num_threads(1)
from metagraph_tpu_torch.parallel import distributed, multihost


def main(rank):
    if rank == 0:
        ok = multihost.initialize(sys.argv[2], 2, 0, device="cpu",
                                  timeout_s=60)
    else:
        ok = multihost.initialize(device="cpu", timeout_s=60)
    mesh = multihost.global_mesh("cpu")
    codes = np.load(sys.argv[4])[rank]
    total, local = distributed.build_distributed_count_step(mesh, 8)(codes)
    print(json.dumps(dict(ok=ok, rank=mesh.rank, size=mesh.size,
                          primary=multihost.is_primary(), total=total,
                          local=local, transport=mesh.transport,
                          jax_imported="jax" in sys.modules)), flush=True)


main(int(sys.argv[3]))
# no mesh outlives the group: one left to interpreter exit can abort it
torch.distributed.destroy_process_group()
"""


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_single_process_noop(monkeypatch):
    for name in TORCHRUN_ENV:
        monkeypatch.delenv(name, raising=False)
    assert multihost.initialize(device="cpu") is False   # no env, no args
    mesh = multihost.global_mesh("cpu")
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)
    assert multihost.is_primary()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Two processes, two slabs of 256 codes (a random read and one
    INVALID each); returns each rank's report and the codes."""
    tmp = tmp_path_factory.mktemp("mh")
    rng = np.random.default_rng(0)
    tbl = DNA.encode_table()
    codes = np.full((2, 256), INVALID_CODE, np.uint8)
    for i in range(2):
        s = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=255))
        codes[i, :255] = tbl[np.frombuffer(s, np.uint8)]
    path = str(tmp / "codes.npy")
    np.save(path, codes)
    port = free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_")) and k != "PYTHONPATH"
           and k not in TORCHRUN_ENV}
    envs = [env, dict(env, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE="2", RANK="1", LOCAL_RANK="0")]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, REPO, f"127.0.0.1:{port}", str(r),
         path], env=envs[r], stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for r in range(2)]
    reports = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err.decode()[-3000:]
            reports.append(json.loads(out.decode().strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return reports, codes


def test_two_process_initialize(two_ranks):
    reports, _ = two_ranks
    assert [r["ok"] for r in reports] == [True, True]
    assert [(r["rank"], r["size"]) for r in reports] == [(0, 2), (1, 2)]
    assert [r["primary"] for r in reports] == [True, False]
    assert {r["transport"] for r in reports} == {"gloo"}
    assert not any(r["jax_imported"] for r in reports)


def test_two_process_count_step(two_ranks):
    """The count step across the two ranks equals the host's count of
    distinct 8-mers of both slabs."""
    reports, codes = two_ranks
    gold = set()
    for row in codes:
        for j in range(row.shape[0] - 8 + 1):
            w = row[j:j + 8]
            if not ((w == INVALID_CODE) | (w == 0)).any():
                gold.add(bytes(w))
    assert [r["total"] for r in reports] == [len(gold)] * 2
    assert sum(r["local"] for r in reports) == len(gold)
