"""The port's multi-process layouts, with real processes on the CPU
(gloo): twins of tests/test_multiprocess.py through
``python -m ahsoka_tpu_torch.dist.sim``.

- mesh: 2 processes x 4 CPU devices share an 8-device mesh
  (data_shards = chain_shards = 8): the sharded projection's min-merge,
  the row blocks' and the DP states' gathers cross the processes; every
  process writes outputs byte-equal to one process over 8 devices.  With
  2 host worker threads too, since every collective stays on the calling
  thread.
- chains: --process-sharding chains at 1 and 2 processes; each rank owns
  a strict subset of the chains, writes its chain files and its metrics,
  and rank 0's merged result is byte-equal to the single process's.

Every run has a time limit, so a hung collective fails the test."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sim(args, tmp_path, timeout=300):
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-m", "ahsoka_tpu_torch.dist.sim", "--device",
         "cpu", "--timeout", str(timeout - 60), "--workdir",
         str(tmp_path / "sim")] + args,
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_sim_defaults_to_cuda(tmp_path, monkeypatch):
    """``--device`` defaults to cuda, and the mesh mode with fewer visible
    cards than ``--nproc`` raises before it starts any child."""
    import torch

    from ahsoka_tpu_torch.dist import sim

    assert sim.build_parser().parse_args([]).device == "cuda"
    started = []
    monkeypatch.setattr(sim, "run_mesh", lambda args: started.append(args))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="--nproc 2"):
        sim.main(["--workdir", str(tmp_path / "sim")])
    assert started == []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert sim.main(["--workdir", str(tmp_path / "sim")]) is None
    assert [a.device for a in started] == ["cuda"]


@pytest.mark.parametrize("threads", [1, 2])
def test_two_process_mesh_byte_equal(tmp_path, threads):
    summary = _sim(["--threads", str(threads)], tmp_path)
    assert summary["byte_equal"], summary["mismatches"]
    assert summary["nproc"] == 2 and summary["global_devices"] == 8
    assert summary["single"]["chains_failed"] == 0
    assert [r["chains_failed"] for r in summary["per_rank"]] == [0, 0]
    # every rank phased every chain over the global mesh
    assert [r["chains_owned"] for r in summary["per_rank"]] == \
        [summary["single"]["chains_owned"]] * 2
    assert summary["files_compared"] >= 2 * 3


def test_chain_sharded_two_process_byte_equal(tmp_path):
    summary = _sim(["--mode", "chains", "--shape", "small", "--sweep", "1",
                    "2"], tmp_path)
    rows = {r["nproc"]: r for r in summary["sweep"]}
    assert summary["byte_equal"] and rows[2]["byte_equal"]
    assert rows[2]["files_compared"] >= 3
    assert all(r["chains_failed"] == 0 for r in rows[2]["per_rank"])
    owned = [r["chains_owned"] for r in rows[2]["per_rank"]]
    assert sum(owned) == rows[1]["per_rank"][0]["chains_owned"]
    assert all(0 < o < sum(owned) for o in owned)
    # rank 1 wrote its own metrics file
    with open(tmp_path / "sim" / "np2" / "run-metrics.rank1.json") as fh:
        m = json.load(fh)
    assert (m["process_index"], m["process_count"]) == (1, 2)
