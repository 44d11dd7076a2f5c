"""The PyTorch port imports no jax, resolves devices strictly, and routes
CPU tensors to the kernels' plain versions."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, os, pkgutil, shutil, sys
import ahsoka_tpu_torch
names = [m.name for m in pkgutil.walk_packages(ahsoka_tpu_torch.__path__,
                                               "ahsoka_tpu_torch.")
         if not m.name.endswith("__main__")]
assert {"ahsoka_tpu_torch.dist.mesh", "ahsoka_tpu_torch.dist.step",
        "ahsoka_tpu_torch.dist.sim", "ahsoka_tpu_torch.thread._native_dp",
        "ahsoka_tpu_torch.thread.dp_assoc", "ahsoka_tpu_torch.utils.editdist",
        "ahsoka_tpu_torch.utils.kmers", "ahsoka_tpu_torch.bench",
        "ahsoka_tpu_torch.scripts.bench_e2e",
        "ahsoka_tpu_torch.scripts.roofline",
        "ahsoka_tpu_torch.scripts.quantify_fastpaths",
        "ahsoka_tpu_torch.scripts.profile_ce",
        "ahsoka_tpu_torch.scripts.plot_bubbles"} <= set(names), names
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401
from ahsoka_tpu_torch.cli.main import main
work, data = sys.argv[1], os.path.join("tests", "data")
shutil.copy(os.path.join(data, "golden_tetra.gaf"), work)
assert main(["phase", "-g", os.path.join(data, "golden_tetra.gfa"), "-a",
             os.path.join(work, "golden_tetra.gaf"), "-o",
             os.path.join(work, "t"), "--device", "cpu", "--ploidy", "4",
             "--no-genotypes"]) == 0
os.makedirs(os.path.join(work, "host"))
shutil.copy(os.path.join(data, "golden_diploid.gaf"),
            os.path.join(work, "host"))
assert main(["phase", "-g", os.path.join(data, "golden_diploid.gfa"), "-a",
             os.path.join(work, "host", "golden_diploid.gaf"), "-o",
             os.path.join(work, "host", "h"), "--device", "cpu",
             "--backend", "host"]) == 0
from ahsoka_tpu_torch.thread._native_dp import native_dp_available
assert native_dp_available()
assert main(["only-bubbles", "-g", os.path.join(data, "golden_diploid.gfa"),
             "-o", os.path.join(work, "b")]) == 0
from ahsoka_tpu_torch import bench
from ahsoka_tpu_torch.scripts import plot_bubbles, profile_ce, roofline
assert bench.main(["--quick", "--device", "cpu"]) == 0
rows, _ = profile_ce.profile(reads=(200,), bubbles=20, skip_sparse=True,
                             device="cpu", workdir=os.path.join(work, "pc"))
assert [r["variant"] for r in rows] == ["dense", "collapsed"]
assert plot_bubbles.main([os.path.join(work, "b-bubbleinfo.txt")]) == 0
assert roofline.row("diploid", 8, 8, 1.0)["roofline_frac"] < 1.05
from ahsoka_tpu_torch.host import loaded_reference_modules
print(len(names), loaded_reference_modules(sys.modules))
"""


def test_port_imports_no_jax(tmp_path):
    """Every port module (the sharded layouts' ``dist/``, the DP oracles,
    the bench and the study tools included) and chip_smoke imported,
    golden_tetra phased on the CPU, golden_diploid phased by the host
    backend, the native DP built, only-bubbles run on golden_diploid, and
    the bench, profile_ce, plot_bubbles and the roofline model run, in a
    fresh process: no jax, no ahsoka_tpu and no ahsoka_tpu.* module was
    loaded, and the outputs equal the committed ones."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL, str(tmp_path)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    count, loaded = out.stdout.strip().splitlines()[-1].split(" ", 1)
    assert int(count) >= 40
    assert loaded == "[]", loaded
    data = os.path.join(REPO, "tests", "data")
    for got, want in [("t-result.txt", "golden_tetra-result.txt"),
                      ("golden_tetra-alignment_identities.txt",
                       "golden_tetra-alignment_identities.txt"),
                      ("b-bubbleinfo.txt", "golden_diploid-bubbleinfo.txt"),
                      ("host/h-result.txt", "golden_diploid-result.txt")]:
        with open(tmp_path / got, "rb") as a, \
                open(os.path.join(data, want), "rb") as b:
            assert a.read() == b.read(), got


def test_resolve_device_cuda_raises_without_card(monkeypatch):
    from ahsoka_tpu_torch.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        resolve_device()


def test_resolve_device_cpu_pins_true_fp32():
    from ahsoka_tpu_torch.device import fp32_settings, resolve_device
    torch.backends.cuda.matmul.allow_tf32 = True
    assert resolve_device("cpu") == torch.device("cpu")
    assert fp32_settings() == {"cuda.matmul.allow_tf32": False,
                               "cudnn.allow_tf32": False,
                               "float32_matmul_precision": "highest"}
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_wrappers_route_cpu_tensors_to_plain_versions(monkeypatch):
    from ahsoka_tpu_torch.ops import _build
    from ahsoka_tpu_torch.ops import minplus_diploid as md

    def no_build(*a, **k):
        raise AssertionError("a CPU tensor must not build a CUDA kernel")

    monkeypatch.setattr(_build, "load", no_build)
    rng = np.random.default_rng(0)
    cand = torch.from_numpy(rng.integers(-1, 5, size=(3, 9, 4))
                            .astype(np.int32))
    node = torch.from_numpy(rng.random((3, 9, 10)).astype(np.float32))
    before = (md.minplus_forward_diploid.launches,
              md.backtrace_diploid.launches)
    fin, bp = md.minplus_forward_diploid(cand, node, switch_cost=32.0,
                                         affine_cost=8.0)
    fin_r, bp_r = md.minplus_forward_diploid_ref(cand, node,
                                                 switch_cost=32.0,
                                                 affine_cost=8.0)
    assert torch.equal(fin, fin_r) and torch.equal(bp, bp_r)
    fs = torch.argmin(fin, dim=1).to(torch.int32)
    assert torch.equal(md.backtrace_diploid(bp, fs),
                       md.backtrace_diploid_ref(bp, fs))
    assert (md.minplus_forward_diploid.launches,
            md.backtrace_diploid.launches) == before


def test_wrappers_check_dtype_shape_contiguity():
    from ahsoka_tpu_torch.ops import minplus_diploid as md
    cand = torch.zeros((2, 5, 4), dtype=torch.int32)
    node = torch.zeros((2, 5, 10), dtype=torch.float32)
    kw = dict(switch_cost=32.0, affine_cost=8.0)
    with pytest.raises(TypeError):
        md.minplus_forward_diploid(cand.long(), node, **kw)
    with pytest.raises(ValueError):
        md.minplus_forward_diploid(cand[:, :, :3].contiguous(), node, **kw)
    with pytest.raises(ValueError):
        md.minplus_forward_diploid(cand.transpose(0, 1), node, **kw)
    with pytest.raises(ValueError):
        md.backtrace_diploid(torch.zeros((2, 5, 10), dtype=torch.int32),
                             torch.zeros(3, dtype=torch.int32))


@pytest.mark.parametrize("argv", [
    ["--num-processes", "2"], ["--data-shards", "2"],
    ["--chain-shards", "2"], ["--process-sharding", "chains"],
    ["--backend", "host"]])
def test_cli_unported_flags_raise(tmp_path, argv, monkeypatch):
    """No flag raises NotImplementedError any more.  The sharding flags
    and ``--backend host`` (the numpy oracle, since it was ported) phase
    golden_diploid on the CPU to the committed result, and
    ``--num-processes 2`` starts the process group through
    ``dist.mesh.initialize_distributed`` (recorded here, not started)."""
    from ahsoka_tpu_torch.cli.main import main
    from ahsoka_tpu_torch.dist import mesh

    started = []
    monkeypatch.setattr(mesh, "initialize_distributed",
                        lambda *a, **k: started.append((a, k)))
    data = os.path.join(REPO, "tests", "data")
    gaf = tmp_path / "golden_diploid.gaf"
    gaf.write_bytes(open(os.path.join(data, "golden_diploid.gaf"),
                         "rb").read())
    assert main(["phase", "-g", os.path.join(data, "golden_diploid.gfa"),
                 "-a", str(gaf), "-o", str(tmp_path / "o"), "--device",
                 "cpu", "--coordinator", "localhost:1", "--process-id",
                 "1"] + argv) == 0
    with open(tmp_path / "o-result.txt", "rb") as a, \
            open(os.path.join(data, "golden_diploid-result.txt"), "rb") as b:
        assert a.read() == b.read()
    if argv[0] == "--num-processes":
        assert started == [((), dict(coordinator="localhost:1",
                                     num_processes=2, process_id=1,
                                     backend="gloo"))]
    else:
        assert started == []
    if argv[0] == "--backend":
        assert list(tmp_path.glob("o-chain*-readset.txt"))


def test_beam_dp_raises_not_implemented():
    """The beam DP is ported: a configured beam narrower than the state
    space runs (it raised NotImplementedError before) and threads like
    the JAX package."""
    from ahsoka_tpu.config import PhasingConfig
    from ahsoka_tpu.thread.dp_jax import thread_chains_batched as jax_tcb
    from ahsoka_tpu_torch.thread.dp_torch import thread_chains_batched

    from test_dp import random_dp_inputs
    cfg = PhasingConfig(ploidy=4, dp_beam_width=16)
    dp = random_dp_inputs(P=6, ploidy=4, num_clusters=6, seed=0)
    assert thread_chains_batched([dp], cfg, device="cpu") == \
        jax_tcb([dp], cfg)
