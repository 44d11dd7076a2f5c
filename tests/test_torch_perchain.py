"""The port's per-chain driver (``batch_dp=False``) and its host backend
(``backend="host"``, the numpy oracle) on the CPU, held to the JAX
package on the same seeded inputs: result, chain and readset debug files
byte-equal to the JAX package's ``batch_dp=False`` and host runs, to the
port's batched driver and to the committed goldens; ``--resume`` and
``--keep-going`` as in ``tests/test_aux.py``; the device warmup in
``-metrics.json``."""

import dataclasses
import glob
import json
import os
import shutil

import pytest
import torch

from ahsoka_tpu.config import PhasingConfig as JaxConfig
from ahsoka_tpu.pipeline import run_phase as jax_run_phase
from ahsoka_tpu_torch.cli.main import main as cli_main
from ahsoka_tpu_torch.config import PhasingConfig
from ahsoka_tpu_torch.pipeline import run_phase

from util import simulate_diploid, simulate_multichain, simulate_polyploid

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _outputs(stem):
    """{suffix: bytes} of a run's result, chain result and readset debug
    files."""
    d, base = os.path.split(stem)
    return {f[len(base):]: _read(os.path.join(d, f))
            for f in os.listdir(d)
            if f.startswith(base + "-")
            and f.endswith((".txt",)) and "metrics" not in f}


def _same(stem_a, stem_b, min_chains=1):
    a, b = _outputs(stem_a), _outputs(stem_b)
    assert a == b, sorted(set(a) ^ set(b)) or \
        [k for k in a if a[k] != b.get(k)]
    assert sum(k.endswith("-result.txt") and "-chain" in k
               for k in a) >= min_chains


def _write(tmp_path, glines, gaf):
    gfa, gaff = tmp_path / "g.gfa", tmp_path / "r.gaf"
    gfa.write_text("".join(glines))
    gaff.write_text("".join(gaf))
    return str(gfa), str(gaff)


@pytest.fixture
def count_dp_calls(monkeypatch):
    """Record the chain count of every port DP call."""
    from ahsoka_tpu_torch.thread import dp_torch

    calls = []
    real = dp_torch.thread_chains_batched

    def spy(dps, *a, **k):
        calls.append(len(dps))
        return real(dps, *a, **k)

    monkeypatch.setattr(dp_torch, "thread_chains_batched", spy)
    return calls


def _perchain_case(tmp_path, gfa, gaf, jax_cfg, cfg, count_dp_calls,
                   chains):
    """The port's per-chain run equals the JAX package's batch_dp=False run
    and the port's batched run; one DP call a phased chain."""
    jax_run_phase(gfa, gaf, str(tmp_path / "jax"),
                  dataclasses.replace(jax_cfg, batch_dp=False))
    art = run_phase(gfa, gaf, str(tmp_path / "seq"),
                    dataclasses.replace(cfg, batch_dp=False), device="cpu")
    assert count_dp_calls == [1] * chains
    batched = run_phase(gfa, gaf, str(tmp_path / "bat"),
                        dataclasses.replace(cfg, batch_dp=True),
                        device="cpu")
    _same(str(tmp_path / "seq"), str(tmp_path / "jax"), chains)
    _same(str(tmp_path / "seq"), str(tmp_path / "bat"), chains)
    assert art.threading["paths"] == batched.threading["paths"]
    with open(tmp_path / "seq-metrics.json") as fh:
        m = json.load(fh)
    assert m["chains_phased"] == chains and m["chains_failed"] == 0
    assert m["total_dp_cells"] > 0
    assert m["stage_seconds"]["dp_device_window"] > 0
    return art


def test_perchain_multichain_matches_jax_and_batched(tmp_path,
                                                     count_dp_calls):
    """The inputs of tests/test_phase_e2e.py:146-168."""
    glines, gaf = simulate_multichain(num_chains=5, bubbles_per_chain=7,
                                      reads_per_hap=10, error_rate=0.04)
    gfa, gaff = _write(tmp_path, glines, gaf)
    _perchain_case(tmp_path, gfa, gaff,
                   JaxConfig(debug_readset_files=False),
                   PhasingConfig(debug_readset_files=False),
                   count_dp_calls, 5)


def test_perchain_golden_tetra(tmp_path, count_dp_calls):
    """golden_tetra (``--ploidy 4 --no-genotypes``) with the readset debug
    files on: equal to the committed result too."""
    gaf = tmp_path / "golden_tetra.gaf"
    shutil.copy(os.path.join(DATA, "golden_tetra.gaf"), gaf)
    _perchain_case(tmp_path, os.path.join(DATA, "golden_tetra.gfa"),
                   str(gaf), JaxConfig(ploidy=4, use_genotypes=False),
                   PhasingConfig(ploidy=4, use_genotypes=False),
                   count_dp_calls, 1)
    assert _read(str(tmp_path / "seq-result.txt")) == \
        _read(os.path.join(DATA, "golden_tetra-result.txt"))
    assert glob.glob(str(tmp_path / "seq-chain*-readset.txt"))


def test_perchain_hexaploid_beam(tmp_path, count_dp_calls):
    """A hexaploid chain with beam width 64 (12,376 states): the beam DP
    at a batch of one."""
    glines, gaf, _haps = simulate_polyploid(ploidy=6, num_bubbles=5,
                                            reads_per_hap=6)
    gfa, gaff = _write(tmp_path, glines, gaf)
    art = _perchain_case(
        tmp_path, gfa, gaff,
        JaxConfig(ploidy=6, dp_beam_width=64, use_genotypes=False,
                  debug_readset_files=False),
        PhasingConfig(ploidy=6, dp_beam_width=64, use_genotypes=False,
                      debug_readset_files=False), count_dp_calls, 1)
    assert [c.ploidy for c in art.threading["configs"]] == [6]


@pytest.mark.parametrize("golden,argv", [
    ("golden_diploid", []),
    ("golden_tetra", ["--ploidy", "4", "--no-genotypes"])])
def test_cli_host_backend_goldens(tmp_path, golden, argv):
    """``--backend host`` through the CLI: the committed goldens, and every
    file (readset debug files included) of the JAX host backend."""
    from ahsoka_tpu.cli.main import main as jax_cli_main

    for tag in ("port", "jax"):
        os.makedirs(tmp_path / tag)
        shutil.copy(os.path.join(DATA, f"{golden}.gaf"), tmp_path / tag)
    args = ["phase", "-g", os.path.join(DATA, f"{golden}.gfa"),
            "--backend", "host"] + argv
    assert cli_main(args + ["-a", str(tmp_path / "port" / f"{golden}.gaf"),
                            "-o", str(tmp_path / "port" / "o"), "--device",
                            "cpu"]) == 0
    assert jax_cli_main(args + ["-a", str(tmp_path / "jax" / f"{golden}.gaf"),
                                "-o", str(tmp_path / "jax" / "o")]) == 0
    _same(str(tmp_path / "port" / "o"), str(tmp_path / "jax" / "o"))
    assert _read(str(tmp_path / "port" / "o-result.txt")) == \
        _read(os.path.join(DATA, f"{golden}-result.txt"))
    assert glob.glob(str(tmp_path / "port" / "o-chain*-readset_final.txt"))
    for got in ("o-bubbleinfo.txt", f"{golden}-alignment_identities.txt"):
        assert _read(str(tmp_path / "port" / got)) == \
            _read(str(tmp_path / "jax" / got))
    with open(tmp_path / "port" / "o-metrics.json") as fh:
        m = json.load(fh)
    assert (m["backend"], m["device"]) == ("host", "cpu")
    assert "device_warmup" not in m["stage_seconds"]


def test_host_backend_agrees_with_debug_files(tmp_path):
    """tests/test_phase_e2e.py:91-111: the port's host backend, the JAX
    host backend and the port's device backend with the readset dumps on
    write the same result and readset files."""
    glines, gaf, _, _ = simulate_diploid(num_bubbles=4, reads_per_hap=6)
    gfa, gaff = _write(tmp_path, glines, gaf)
    run_phase(gfa, gaff, str(tmp_path / "h"),
              PhasingConfig(backend="host", debug_readset_files=True),
              device="cpu")
    jax_run_phase(gfa, gaff, str(tmp_path / "jh"),
                  JaxConfig(backend="host", debug_readset_files=True))
    run_phase(gfa, gaff, str(tmp_path / "d"),
              PhasingConfig(debug_readset_files=True), device="cpu")
    _same(str(tmp_path / "h"), str(tmp_path / "jh"))
    _same(str(tmp_path / "h"), str(tmp_path / "d"))
    assert glob.glob(str(tmp_path / "h-chain*-readset.txt"))


def test_host_backend_triploid(tmp_path):
    """tests/test_phase_e2e.py:132-143 against the JAX host backend."""
    glines, gaf, _haps = simulate_polyploid(ploidy=3, num_bubbles=4,
                                            reads_per_hap=8)
    gfa, gaff = _write(tmp_path, glines, gaf)
    run_phase(gfa, gaff, str(tmp_path / "t"),
              PhasingConfig(ploidy=3, backend="host", use_genotypes=False),
              device="cpu")
    jax_run_phase(gfa, gaff, str(tmp_path / "j"),
                  JaxConfig(ploidy=3, backend="host", use_genotypes=False))
    _same(str(tmp_path / "t"), str(tmp_path / "j"))
    text = _read(str(tmp_path / "t-result.txt")).decode()
    assert text.count("haplotype") == 3


@pytest.mark.parametrize("backend,batch_dp", [("host", False),
                                              ("jax", False)])
def test_resume_and_keep_going(tmp_path, monkeypatch, backend, batch_dp):
    """tests/test_aux.py:23-55 on both per-chain runs: the metrics file,
    ``resume`` reuses the chain result, ``keep_going`` records an injected
    failure of ``phase_one_chain``."""
    from ahsoka_tpu_torch import phase as phase_mod

    glines, gaf, _, _ = simulate_diploid(num_bubbles=5, reads_per_hap=8)
    gfa, gaff = _write(tmp_path, glines, gaf)
    cfg = PhasingConfig(backend=backend, batch_dp=batch_dp)
    out = str(tmp_path / "o")
    run_phase(gfa, gaff, out, cfg, device="cpu")
    first = _read(out + "-result.txt")
    with open(out + "-metrics.json") as fh:
        m = json.load(fh)
    assert m["chains_phased"] == 1 and m["total_dp_cells"] > 0
    assert m["reads_per_s"] > 0 and m["chains"][0]["reads"] > 0
    run_phase(gfa, gaff, out, cfg, device="cpu", resume=True)
    assert _read(out + "-result.txt") == first
    with open(out + "-metrics.json") as fh:
        assert json.load(fh)["chains"][0]["resumed"] is True

    def boom(*a, **k):
        raise RuntimeError("injected fault")

    monkeypatch.setattr(phase_mod, "phase_one_chain", boom)
    run_phase(gfa, gaff, str(tmp_path / "kg"), cfg, device="cpu",
              keep_going=True)
    with open(tmp_path / "kg-metrics.json") as fh:
        m = json.load(fh)
    assert m["chains_failed"] == 1
    assert "injected fault" in m["chains"][0]["error"]
    with pytest.raises(RuntimeError, match="injected"):
        run_phase(gfa, gaff, str(tmp_path / "kg0"), cfg, device="cpu")


@pytest.mark.parametrize("batch_dp", [True, False])
def test_metrics_device_warmup(tmp_path, monkeypatch, batch_dp):
    """The device backend records the warmup outside the phase timer, on
    both drivers: one round trip, counted, and no probe beside it."""
    from ahsoka_tpu_torch import phase as phase_mod

    order = []
    real_warmup = phase_mod.device_warmup
    real_batched = phase_mod.phase_all_chains_batched
    real_seq = phase_mod.phase_all_chains
    monkeypatch.setattr(phase_mod, "device_warmup",
                        lambda *a: (order.append("warmup"),
                                    real_warmup(*a))[1])
    monkeypatch.setattr(phase_mod, "phase_all_chains_batched",
                        lambda *a, **k: (order.append("batched"),
                                         real_batched(*a, **k))[1])
    monkeypatch.setattr(phase_mod, "phase_all_chains",
                        lambda *a, **k: (order.append("perchain"),
                                         real_seq(*a, **k))[1])
    glines, gaf, _, _ = simulate_diploid(num_bubbles=4, reads_per_hap=6)
    gfa, gaff = _write(tmp_path, glines, gaf)
    run_phase(gfa, gaff, str(tmp_path / "o"),
              PhasingConfig(batch_dp=batch_dp), device="cpu")
    assert order == ["warmup", "batched" if batch_dp else "perchain"]
    with open(tmp_path / "o-metrics.json") as fh:
        m = json.load(fh)
    stages = m["stage_seconds"]
    assert m["rate_excludes_device_warmup"] is True
    assert "device_rtt_est" not in stages
    assert stages["device_warmup"] == m["spans"]["device_warmup"]["wall_s"]
    assert m["spans"]["device_warmup"]["calls"] == 1
    # inside the job, before and apart from the phase timer
    assert 0 < stages["device_warmup"]
    assert stages["device_warmup"] + stages["phase"] \
        <= m["spans"]["job"]["wall_s"]


def test_device_warmup_records_and_raises(monkeypatch):
    from ahsoka_tpu_torch.phase import device_warmup
    from ahsoka_tpu_torch.utils import substage

    marks = {}
    with substage.job():
        device_warmup(marks, torch.device("cpu"))
        counters = substage.snapshot()["counters"]
    assert set(marks) == {"device_warmup"}
    assert counters == {"device.round_trips": 1}

    def no_card(*a, **k):
        raise RuntimeError("no card")

    monkeypatch.setattr(torch, "zeros", no_card)
    marks = {}
    with pytest.raises(RuntimeError, match="no card"):
        device_warmup(marks, torch.device("cpu"))
    assert set(marks) == {"device_warmup"}


def test_host_backend_refuses_columns(tmp_path):
    glines, gaf, _, _ = simulate_diploid(num_bubbles=4, reads_per_hap=6)
    gfa, gaff = _write(tmp_path, glines, gaf)
    with pytest.raises(ValueError, match="columnar"):
        run_phase(gfa, gaff, str(tmp_path / "o"),
                  PhasingConfig(backend="host"), device="cpu",
                  columnar=True)
