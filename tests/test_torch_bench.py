"""The port's bench (``ahsoka_tpu_torch.bench``) and roofline model
(``ahsoka_tpu_torch/scripts/roofline.py``) against the JAX package's.

- ``make_dp_workload`` gives the same arrays as ``bench.make_dp_workload``
  for the same seed;
- the bench's ``cuda`` DP function (its wrappers run their plain versions
  on CPU tensors) and its ``plain`` one against the JAX package's
  ``batched_dp_forward`` (bench.py's ``xla`` kernel, jitted): backpointers
  and final states exactly equal; against the Pallas kernels in interpret
  mode: states exactly equal, final costs within one float32 ulp (as
  tests/test_torch_minplus_diploid.py holds them);
- the projection bench's key tables exactly equal to the JAX
  ``containment_keys_core``'s at a reduced shape;
- the roofline counts equal hand sums, ``bound`` keeps the values the
  smoke's kernel line had, and a fraction above 1.05 raises."""

import functools
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ahsoka_tpu.dist.step import batched_dp_forward
from ahsoka_tpu.thread import dp_jax
from ahsoka_tpu_torch import bench as port_bench
from ahsoka_tpu_torch.scripts import roofline
from ahsoka_tpu_torch.state import to_torch
from ahsoka_tpu_torch.thread import dp_kernels

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import bench as jax_bench  # noqa: E402  (the JAX package's bench.py)

KW = dict(switch_cost=32.0, affine_cost=8.0)
# (ploidy, chains, positions): bench.py --quick's diploid workload, and a
# tetraploid one small enough for the plain versions on one CPU thread
# (P a multiple of the streamed Pallas wrapper's position block)
WORKLOADS = [(2, 32, 128), (4, 3, 16)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("ploidy", [2, 4])
def test_make_dp_workload_byte_equal(seed, ploidy):
    want = jax_bench.make_dp_workload(5, 17, ploidy, seed=seed)
    got = port_bench.make_dp_workload(5, 17, ploidy, seed=seed)
    assert got[7] == want[7]
    for g, w in zip(got[:7], want[:7]):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def _spy_backptrs(monkeypatch):
    """Record the backpointers the bench's cuda function hands its
    backtrace wrapper."""
    seen = []
    for name in ("backtrace_diploid", "backtrace_streamed"):
        real = getattr(dp_kernels, name)

        def spy(bp, fs, _real=real):
            seen.append(bp)
            return _real(bp, fs)
        monkeypatch.setattr(dp_kernels, name, spy)
    return seen


def _jax_xla(workload, k):
    ca, nc, co, cs, ge, ct, vt, _S = workload
    fn = jax.jit(functools.partial(
        batched_dp_forward, ploidy=k, num_alleles=2, cov_w=1.0, geno_w=1.0,
        **KW))
    fs, bp = fn(*(jnp.asarray(x) for x in (ca, nc, co, cs, ge, ct, vt)))
    s0, tail = dp_jax._backtrace_batched(fs, bp)
    states = np.concatenate([np.asarray(s0)[:, None], np.asarray(tail)],
                            axis=1)
    return np.asarray(fs), np.asarray(bp), states


@pytest.mark.parametrize("kernel", ["cuda", "plain"])
@pytest.mark.parametrize("k,C,P", WORKLOADS)
def test_bench_dp_matches_xla(monkeypatch, kernel, k, C, P):
    w = port_bench.make_dp_workload(C, P, k, seed=3)
    seen = _spy_backptrs(monkeypatch)
    fn = port_bench.dp_function(kernel, k, w[5], w[6])
    states, fin = fn(*to_torch(*w[:5], device="cpu"))
    fs_j, bp_j, st_j = _jax_xla(w, k)
    np.testing.assert_array_equal(
        torch.argmin(fin, dim=1).to(torch.int32).numpy(), fs_j)
    np.testing.assert_array_equal(states.numpy(), st_j)
    if kernel == "cuda":
        (bp,) = seen
        assert not bp[:, 0].any()
        np.testing.assert_array_equal(bp[:, 1:].numpy(), bp_j)


@pytest.mark.parametrize("k,C,P", WORKLOADS)
def test_bench_dp_matches_pallas_interpret(k, C, P):
    from jax.experimental.pallas import tpu as pltpu
    from ahsoka_tpu.thread.dp_pallas import (thread_batch_pallas_diploid,
                                             thread_batch_pallas_streamed)

    if k == 2:
        C, P = 3, 24                   # interpret mode pads to 1024 chains
    w = port_bench.make_dp_workload(C, P, k, seed=4)
    pallas = (thread_batch_pallas_diploid if k == 2
              else thread_batch_pallas_streamed)
    with pltpu.force_tpu_interpret_mode():
        st_p, fin_p = pallas(*w[:7], ploidy=k, num_alleles=2,
                             pad_to=1024 if k == 2 else 128, **KW)
    states, fin = port_bench.dp_function("cuda", k, w[5], w[6])(
        *to_torch(*w[:5], device="cpu"))
    np.testing.assert_array_equal(states.numpy(), np.asarray(st_p))
    np.testing.assert_array_max_ulp(fin.numpy(), np.asarray(fin_p),
                                    maxulp=1)


def test_projection_keys_match_jax():
    from ahsoka_tpu.project.device import containment_keys_core

    shape = dict(B=24, APB=2, V=96, A=640, L=12, N=160, CHUNK=128)
    got = port_bench.projection_function(torch.device("cpu"), 5, **shape)()
    arrays = port_bench.projection_inputs(5, **shape)
    want = jax.jit(functools.partial(
        containment_keys_core, num_bubbles=shape["B"], num_names=shape["N"],
        chunk=shape["CHUNK"], alleles_per_bubble=shape["APB"]))(
        *(jnp.asarray(a) for a in arrays), jnp.float32(90.0))
    assert got.shape == (1, 3, shape["B"], shape["N"])
    for t in range(3):
        np.testing.assert_array_equal(got[0, t].numpy(), np.asarray(want[t]))
    assert (got != 2 ** 31 - 1).any()


def test_seconds_per_call_grows_the_window():
    calls = []

    def fn():
        calls.append(1)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 1e-3:
            pass

    sec = port_bench.seconds_per_call(fn, torch.device("cpu"),
                                      min_window=0.02)
    assert 1e-3 <= sec < 5e-3
    assert len(calls) >= 1 + 3 * 20          # warm-up, then 3 windows >= 20


def test_bench_main_quick_cpu(capsys):
    before = dict(dp_kernels.launch_counts())
    assert port_bench.main(["--quick", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # bench.py's keys, device in place of backend, and the extras
    jax_keys = {"metric", "value", "unit", "vs_baseline",
                "baseline_native_cells_per_s", "projection_reads_per_s",
                "tetraploid_cells_per_s", "dp_step_seconds",
                "host_rtt_seconds", "e2e_ok", "extras_file", "chains",
                "positions", "ploidy", "kernel", "backend"}
    extras = {"plain_cells_per_s", "tetraploid_plain_cells_per_s",
              "tetraploid_native_cells_per_s", "tetraploid_chains_positions",
              "projection_shape", "gpu"}
    assert set(out) == (jax_keys - {"backend"}) | {"device"} | extras
    assert out["kernel"] == "cuda" and out["device"] == "cpu"
    assert (out["chains"], out["positions"]) == (32, 128)
    for key in ("value", "plain_cells_per_s", "baseline_native_cells_per_s",
                "projection_reads_per_s", "vs_baseline"):
        assert out[key] > 0
    assert out["gpu"] is None
    # CPU tensors run the plain versions: no kernel launch counted
    assert dp_kernels.launch_counts() == before


def test_roofline_counts_equal_hand_sums():
    # diploid (M=4, S=10, A=2) at C=3, P=5
    assert roofline.work("node_costs", 2, 3, 5) == (
        4 * 15 * (12 + 1 + 2) + 40 + 50 + 4 * 15 * 10, 150 * 38, 0)
    assert roofline.work("dpk_forward_warp", 2, 3, 5) == (
        4 * 15 * 24 + 4 * 3 * 10 + 40, 2 * 1200, 2 * 1200 * 4 * 2)
    assert roofline.work("dpk_backtrace", 2, 3, 5) == (120, 0, 0)
    r = roofline.row("diploid", 3, 5, seconds=1.0)
    assert (r["bytes"], r["fp32_ops"], r["int8_ops"]) == (3310, 8100, 19200)
    assert r["bound_by"] == "bytes"
    assert r["bound_seconds"] == pytest.approx(3310 / 3.35e12)
    assert r["achieved_bytes_per_s"] == 3310
    assert r["cells_per_s"] == 3 * 4 * 100
    # tetraploid (M=8, S=330) at C=2, P=3: the operations bind
    t = roofline.row("tetraploid", 2, 3, seconds=1.0)
    cells = 2 * 2 * 330 * 330
    assert t["fp32_ops"] == 2 * 3 * 330 * (24 + 32 + 6 + 4) + 2 * cells
    assert t["int8_ops"] == 2 * cells * 8 * 4
    assert t["bytes"] == (4 * 6 * 27 + 330 * 8 + 9 * 330 + 4 * 6 * 330) \
        + (4 * 6 * (8 + 660) + 4 * 2 * 330 + 330 * 8) + 4 * 2 * 6
    assert t["bound_by"] == "operations"


def _old_bound(kernel, k, C, P):
    """The bound of chip_smoke.py's kernel line before it moved into the
    roofline module, written out."""
    from math import comb
    M, S = 2 * k, comb(3 * k - 1, k)
    if kernel.endswith("backtrace"):
        nbytes, op_s = 4 * C * (2 * P), 0.0
    else:
        nbytes = 4 * C * P * (M + 2 * S) + 4 * C * S + S * M
        cells = C * max(P - 1, 0) * S * S
        op_s = 2 * cells / 67e12 + 2 * cells * M * k / 1979e12
    byte_s = nbytes / 3.35e12
    return max(byte_s, op_s) * 1e3, ("bytes" if byte_s >= op_s
                                     else "operations")


@pytest.mark.parametrize("kernel,k,C,P", [
    ("dpk_forward_warp", 2, 1000, 56), ("dpk_backtrace", 2, 1000, 56),
    ("dpk_forward", 4, 20, 256), ("dpk_backtrace", 4, 20, 256),
    ("dpk_forward", 5, 4, 64), ("dpk_forward_warp", 1, 1, 10000)])
def test_bound_keeps_the_kernel_line_values(kernel, k, C, P):
    import chip_smoke

    got = roofline.bound(kernel, k, C, P)
    assert got[1] == _old_bound(kernel, k, C, P)[1]
    assert got[0] == pytest.approx(_old_bound(kernel, k, C, P)[0],
                                   rel=1e-12)
    # chip_smoke.py takes its bound from the roofline module
    assert not hasattr(chip_smoke, "bound")
    assert not hasattr(chip_smoke, "HBM_BYTES_S")


def test_roofline_fraction_above_limit_raises():
    least = roofline.row("diploid", 3, 5, seconds=1.0)["bound_seconds"]
    assert roofline.row("diploid", 3, 5, least)["roofline_frac"] == 1.0
    assert roofline.row("diploid", 3, 5, least / 1.04)["roofline_frac"] \
        <= roofline.MAX_FRAC
    with pytest.raises(ValueError, match="work count"):
        roofline.row("diploid", 3, 5, least / 1.06)


def test_roofline_main_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(roofline, "BUILD_BENCH", str(tmp_path))
    assert roofline.main(["--device", "cpu", "--chains", "4", "--positions",
                          "12", "--tetra-chains", "2"]) == 0
    out = json.loads(capsys.readouterr().out)
    with open(tmp_path / "roofline.json") as fh:
        assert json.load(fh) == out
    assert [r["row"] for r in out["rows"]] == ["diploid", "tetraploid"]
    assert [(r["chains"], r["positions"]) for r in out["rows"]] == \
        [(4, 12), (2, 12)]
    assert out["device"] == "cpu" and out["gpu"] is None
    assert all(0 < r["roofline_frac"] <= 1.05 for r in out["rows"])
