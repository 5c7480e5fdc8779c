"""``repro_torch.launch.train`` across ranks on the CPU.

Two ranks of a ``gloo`` group, each a ``python -m repro_torch.launch.train
--device cpu`` process with the environment ``torchrun`` gives its workers
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``),
train on the reference's (2, 1) ("data", "model") mesh: params under
``tp``, Yogi's state under ``fsdp``, the clustering state replicated, the
clients split over ``data``. Their printed losses and rank 0's checkpoints
equal the one-device run's, before and after ``--resume``, and an odd
``--clients`` stops both ranks with a message.
"""
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

from repro_torch.launch import train as ttrain

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--device", "cpu", "--layers", "2", "--d-model", "64", "--vocab", "256", "--seq", "32",
        "--clients", "4", "--checkpoint-every", "1"]
ROUND = re.compile(r"^round +(\d+) loss (\S+) disp (\S+)", re.MULTILINE)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _ranks(argv, world=2):
    """The driver on ``world`` gloo ranks: [(returncode, stdout, stderr)] by rank."""
    port = _free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, "-m", "repro_torch.launch.train", *argv], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT))
    outs = [p.communicate(timeout=300) for p in procs]
    return [(p.returncode, o, e) for p, (o, e) in zip(procs, outs)]


def _one_device(argv, capsys, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    ttrain.main(argv)
    return capsys.readouterr().out


def _losses(out):
    return np.array([[float(x) for x in m] for m in ROUND.findall(out)])


def _assert_checkpoints_equal(a: Path, b: Path):
    """At ``tests/test_torch_profile.py``'s tolerances for a train step
    across ranks: rtol 1e-4, atol 1e-5, the counts equal, and the centroids
    (unit vectors of the clients' centered sketches, which cancel to ~1e-2
    of the sketches' scale, so the deltas' float32 rounding shows there at
    ~2e-5 of a unit vector) at 1e-4 of a unit vector."""
    for name in ("params", "opt", "clust"):
        got, want = np.load(a / f"{name}.npz"), np.load(b / f"{name}.npz")
        assert sorted(got.files) == sorted(want.files), name
        for k in want.files:
            if k == "['counts']":
                np.testing.assert_array_equal(got[k], want[k])
            elif k == "['centroids']":
                np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4, err_msg=k)
            else:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=f"{name}{k}")


def test_two_gloo_ranks_equal_one_device_and_resume(tmp_path, capsys, monkeypatch):
    one, ranks = tmp_path / "one", tmp_path / "ranks"
    want = _one_device(ARGS + ["--rounds", "2", "--ckpt-dir", str(one)], capsys, monkeypatch)
    res = _ranks(ARGS + ["--rounds", "2", "--ckpt-dir", str(ranks)])
    assert [r[0] for r in res] == [0, 0], res[0][2][-3000:]
    got = res[0][1]
    assert "placement on a (2, 1) (data, model) mesh" in got and "done" in got and res[1][1] == ""
    # round 0 and 1 (loss, dispersion), printed to 4 and 3 decimals: equal
    # within one unit of the last printed digit
    np.testing.assert_allclose(_losses(got), _losses(want), rtol=1e-4, atol=1e-3)
    assert _losses(got).shape == (2, 3) and got.count("checkpointed at round") == 2
    _assert_checkpoints_equal(ranks, one)
    before = dict(np.load(ranks / "params.npz"))

    # --resume: every rank loads rank 0's checkpoint and continues from it
    want = _one_device(ARGS + ["--rounds", "1", "--resume", "--ckpt-dir", str(one)], capsys, monkeypatch)
    res = _ranks(ARGS + ["--rounds", "1", "--resume", "--ckpt-dir", str(ranks)])
    assert [r[0] for r in res] == [0, 0], res[0][2][-3000:]
    assert f"resumed from {ranks}" in res[0][1]
    np.testing.assert_allclose(_losses(res[0][1]), _losses(want), rtol=1e-4, atol=1e-3)
    _assert_checkpoints_equal(ranks, one)
    after = np.load(ranks / "params.npz")
    assert any(not np.array_equal(after[k], before[k]) for k in before)


def test_clients_not_divisible_by_the_world_size_stop_every_rank(tmp_path):
    res = _ranks(ARGS + ["--rounds", "1", "--clients", "3", "--ckpt-dir", str(tmp_path)])
    for rc, out, err in res:
        assert rc == 2 and "--clients 3 is not divisible by the world size 2" in err
        assert "round" not in out


def test_one_rank_group_equals_one_device(tmp_path, capsys, monkeypatch):
    """A 1-rank group (``torchrun --nproc-per-node 1``, the card's case runs
    on NCCL) joins its group and trains as a run alone does, on plain
    tensors, to the one-device run's checkpoint."""
    want = _one_device(ARGS + ["--rounds", "2", "--ckpt-dir", str(tmp_path / "one")], capsys, monkeypatch)
    res = _ranks(ARGS + ["--rounds", "2", "--ckpt-dir", str(tmp_path / "ranks")], world=1)
    assert res[0][0] == 0, res[0][2][-3000:]
    assert "placement on a (1, 1) (data, model) mesh" in res[0][1]
    np.testing.assert_allclose(_losses(res[0][1]), _losses(want), rtol=1e-4, atol=1e-3)
    _assert_checkpoints_equal(tmp_path / "ranks", tmp_path / "one")
