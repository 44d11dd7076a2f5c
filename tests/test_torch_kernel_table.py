"""chip_smoke.py's kernel table against the sources, read as text.

Every ``pl.pallas_call`` of the JAX package must be replaced by a CUDA
kernel of the port that ``chip_smoke.KERNEL_META`` names, every
``__global__`` kernel of ``ahsoka_tpu_torch/csrc`` must be named there,
and every file the table names must exist.  Nothing is built or run."""

import glob
import os
import re

import pytest

import chip_smoke
from ahsoka_tpu_torch.thread import dp_kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SITE = re.compile(r"(ahsoka_tpu/[\w/]+\.py):(\d+)")


def _read(rel):
    with open(os.path.join(REPO, rel)) as fh:
        return fh.read()


def _pallas_call_sites():
    sites = []
    for path in sorted(glob.glob(os.path.join(REPO, "ahsoka_tpu", "**",
                                              "*.py"), recursive=True)):
        rel = os.path.relpath(path, REPO)
        for i, line in enumerate(_read(rel).splitlines(), 1):
            code = line.split("#", 1)[0]
            if re.search(r"\bpl\.pallas_call\(", code):
                sites.append(f"{rel}:{i}")
    return sites


def _cuda_kernels():
    found = []
    for path in sorted(glob.glob(os.path.join(REPO, "ahsoka_tpu_torch",
                                              "csrc", "*.cu"))):
        text = open(path).read()
        found += re.findall(r"__global__\s+void\s+(?:__launch_bounds__"
                            r"\([^)]*\)\s+)?(\w+)\s*\(", text)
    return found


def _replaced():
    return " ".join(rep for _, _, rep, _, _ in chip_smoke.KERNEL_META.values())


def test_pallas_call_sites_found():
    # the four sites of the JAX package: _dp_kernel, _stream_kernel(_ge),
    # _bt2_kernel, _dp2_kernel
    assert len(_pallas_call_sites()) == 4


@pytest.mark.parametrize("site", _pallas_call_sites())
def test_every_pallas_call_has_a_port(site):
    assert site in _replaced()


def test_cuda_kernels_found():
    assert sorted(_cuda_kernels()) == ["dpk_backtrace", "dpk_forward",
                                       "dpk_forward_warp"]


@pytest.mark.parametrize("kernel", _cuda_kernels())
def test_every_cuda_kernel_is_in_the_table(kernel):
    names = {name for name, *_ in chip_smoke.KERNEL_META.values()}
    assert kernel in names
    assert kernel in chip_smoke.DP_KERNELS
    # the kernel's launch count is what the end-to-end runs read
    assert kernel in dp_kernels.launch_counts()


@pytest.mark.parametrize("row", sorted(chip_smoke.KERNEL_META))
def test_named_files_exist(row):
    name, src, rep, run, case = chip_smoke.KERNEL_META[row]
    assert os.path.isfile(os.path.join(REPO, src))
    assert re.search(rf"\b{name}\b", _read(src))
    sites = _SITE.findall(rep)
    assert sites
    for rel, line in sites:
        assert int(line) <= len(_read(rel).splitlines()), (rel, line)
    assert case in chip_smoke.CASE_SHAPES
    assert run in ("config4s", "config3c")


def test_kernel_table_lists_each_tpu_row_once():
    rows = chip_smoke.KERNEL_META
    assert set(rows) == {"_dp2_kernel", "_bt2_kernel", "_stream_kernel_ge",
                         "xla_scan_backtrace"}
    for row in ("_dp2_kernel", "_bt2_kernel"):
        assert f"({row};" in rows[row][2]
