"""General-ploidy DP forward + backtrace of the port against the JAX package.

The port's ``minplus_forward_streamed`` / ``backtrace_streamed`` run
their plain PyTorch versions on CPU tensors (the CUDA kernel is held
against those on a card: tests/test_torch_cuda.py and chip_smoke.py).
The same seeded numpy inputs and node costs go through the three Pallas
bodies the CUDA kernel replaces, in interpret mode, at shapes where the
Pallas wrappers add no positions:

- ``_stream_kernel_ge`` and ``_stream_kernel`` (``minplus_forward_streamed``
  with ``ge`` True and False) at ploidy 1-4;
- ``_dp_kernel`` (``ahsoka_tpu.ops.minplus.minplus_forward``) at ploidy 1-4;

and the XLA scan (``dp_jax._dp_forward_batched``) at ploidy 1-5 (at 5,
2002 states, interpret mode is too slow).  Final costs, backpointers and
states must be exactly equal: every transition cost is a small integer,
exact in float32, and each add is one rounding on both sides.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ahsoka_tpu.config import PhasingConfig
from ahsoka_tpu.ops.minplus import LANES
from ahsoka_tpu.thread import dp_jax
from ahsoka_tpu.thread.states import full_state_counts, full_state_validity
from ahsoka_tpu_torch.ops import minplus_stream as ms
from ahsoka_tpu_torch.state import to_torch
from ahsoka_tpu_torch.thread import dp_torch

from test_dp import random_dp_inputs

torch.set_num_threads(1)

CFG = PhasingConfig()
KW = dict(switch_cost=CFG.switch_cost, affine_cost=CFG.affine_switch_cost)


def _inputs(k, C, P, seed, ties=False):
    """Chain-batched DP arrays and their [C, P, S] node costs (numpy).
    ``ties``: the same two candidates everywhere and zero node-cost
    weights, so every valid state costs the same at every position."""
    dps = [random_dp_inputs(P=P, ploidy=k, num_clusters=2 * k + 1,
                            seed=seed * 100 + i) for i in range(C)]
    arrays = dp_torch._pack_group(dps, list(range(C)), P)
    ca, nc = arrays[0], arrays[1]
    if ties:
        ca[:] = -1
        ca[:, :, :2] = [0, 1]
        nc[:] = 2
    w = 0.0 if ties else 1.0
    node = dp_torch.node_costs_all(
        *to_torch(*arrays, device="cpu"), full_state_counts(k),
        full_state_validity(k), ploidy=k, num_alleles=arrays[4].shape[2],
        cov_w=w, geno_w=w)
    return arrays, node.numpy(), w


def _port(cand, node, k):
    fin, bp = ms.minplus_forward_streamed(
        torch.from_numpy(cand), torch.from_numpy(node), full_state_counts(k),
        ploidy=k, **KW)
    st = ms.backtrace_streamed(bp, torch.argmin(fin, dim=1).to(torch.int32))
    return fin.numpy(), bp.numpy(), st.numpy()


def _lane_padded(cand, node):
    """Pad the chain axis to one 128-lane block, as the Pallas wrappers
    require (sentinel chains: no candidates, zero node costs)."""
    pad = (-cand.shape[0]) % LANES
    return (np.pad(cand, ((0, pad), (0, 0), (0, 0)), constant_values=-1),
            np.pad(node, ((0, pad), (0, 0), (0, 0))))


def _pallas(body, cand, node, k):
    from jax.experimental.pallas import tpu as pltpu
    from ahsoka_tpu.ops.minplus import minplus_forward
    from ahsoka_tpu.ops.minplus_stream import minplus_forward_streamed

    C, P, _ = cand.shape
    pc, pn = _lane_padded(cand, node)
    args = (jnp.asarray(pc), jnp.asarray(pn),
            jnp.asarray(full_state_counts(k)))
    with pltpu.force_tpu_interpret_mode():
        if body == "resident":
            fin, bp = minplus_forward(*args, ploidy=k, **KW)
        else:
            fin, bp = minplus_forward_streamed(*args, ploidy=k,
                                               ge=body == "ge", **KW)
    fin, bp = np.asarray(fin)[:C], np.asarray(bp)[:C]
    assert bp.shape[1] == P, "the Pallas wrapper added positions"
    return fin, bp


def _xla_scan(arrays, k, w):
    fs, bp = dp_jax._dp_forward_batched(
        *[jnp.asarray(a) for a in arrays], jnp.asarray(full_state_counts(k)),
        jnp.asarray(full_state_validity(k)), jnp.float32(CFG.switch_cost),
        jnp.float32(CFG.affine_switch_cost), jnp.float32(w), jnp.float32(w),
        ploidy=k, num_alleles=arrays[4].shape[2])
    s0, tail = dp_jax._backtrace_batched(fs, bp)
    states = np.concatenate([np.asarray(s0)[:, None], np.asarray(tail)],
                            axis=1)
    return np.asarray(fs), np.asarray(bp), states


# (ploidy, chains, positions): ragged chain counts, P a multiple of the
# streamed wrapper's position block (no padding positions)
PALLAS_SHAPES = [(1, 5, 24), (2, 3, 16), (3, 2, 16), (4, 2, 8)]


@pytest.mark.parametrize("body", ["ge", "sweep"])
@pytest.mark.parametrize("k,C,P", PALLAS_SHAPES)
def test_plain_matches_stream_kernels(body, k, C, P):
    arrays, node, _ = _inputs(k, C, P, seed=k + P)
    fin, bp, _ = _port(arrays[0], node, k)
    fin_p, bp_p = _pallas(body, arrays[0], node, k)
    np.testing.assert_array_equal(fin, fin_p)
    np.testing.assert_array_equal(bp, bp_p)


@pytest.mark.parametrize("k,C,P", PALLAS_SHAPES)
def test_plain_matches_resident_kernel(k, C, P):
    arrays, node, _ = _inputs(k, C, P, seed=7 * k + P)
    fin, bp, _ = _port(arrays[0], node, k)
    fin_p, bp_p = _pallas("resident", arrays[0], node, k)
    np.testing.assert_array_equal(fin, fin_p)
    np.testing.assert_array_equal(bp, bp_p)


@pytest.mark.parametrize("k,C,P", [(1, 7, 33), (2, 5, 41), (3, 3, 19),
                                   (4, 2, 12), (5, 1, 4)])
def test_plain_matches_xla_scan(k, C, P):
    arrays, node, w = _inputs(k, C, P, seed=3 * k + C)
    fin, bp, st = _port(arrays[0], node, k)
    fs_j, bp_j, st_j = _xla_scan(arrays, k, w)
    assert bp.shape == (C, P, full_state_counts(k).shape[0])
    assert not bp[:, 0].any()
    np.testing.assert_array_equal(bp[:, 1:], bp_j)
    np.testing.assert_array_equal(np.argmin(fin, axis=1), fs_j)
    np.testing.assert_array_equal(st, st_j)


@pytest.mark.parametrize("body", ["xla", "ge", "sweep", "resident"])
def test_plain_all_ties(body):
    """Every valid state ties at every position: the first minimum wins
    in the port (strict < / argmin) and in each JAX body."""
    k, C, P = 3, 3, 16
    arrays, node, w = _inputs(k, C, P, seed=5, ties=True)
    fin, bp, st = _port(arrays[0], node, k)
    valid = fin[fin < 1e29]
    assert (valid == valid[0]).all()
    if body == "xla":
        fs_j, bp_j, st_j = _xla_scan(arrays, k, w)
        np.testing.assert_array_equal(bp[:, 1:], bp_j)
        np.testing.assert_array_equal(st, st_j)
    else:
        fin_p, bp_p = _pallas(body, arrays[0], node, k)
        np.testing.assert_array_equal(fin, fin_p)
        np.testing.assert_array_equal(bp, bp_p)


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    from ahsoka_tpu_torch.ops import _build

    def no_build(*a, **k):
        raise AssertionError("a CPU tensor must not build a CUDA kernel")

    monkeypatch.setattr(_build, "load", no_build)
    arrays, node, _ = _inputs(3, 2, 9, seed=1)
    before = (ms.minplus_forward_streamed.launches,
              ms.backtrace_streamed.launches)
    fin, bp, st = _port(arrays[0], node, 3)
    assert (ms.minplus_forward_streamed.launches,
            ms.backtrace_streamed.launches) == before
    assert fin.shape == (2, 56) and bp.shape == (2, 9, 56)
    assert st.shape == (2, 9) and st.dtype == np.int32


def test_empty_batches():
    counts = full_state_counts(3)
    fin, bp = ms.minplus_forward_streamed(
        torch.zeros((0, 5, 6), dtype=torch.int32),
        torch.zeros((0, 5, 56)), counts, ploidy=3, **KW)
    assert fin.shape == (0, 56) and bp.shape == (0, 5, 56)
    st = ms.backtrace_streamed(torch.zeros((2, 1, 56), dtype=torch.int32),
                               torch.tensor([4, 9], dtype=torch.int32))
    assert st.tolist() == [[4], [9]]


def test_wrapper_checks():
    counts = full_state_counts(3)
    cand = torch.zeros((2, 4, 6), dtype=torch.int32)
    node = torch.zeros((2, 4, 56))
    fwd = ms.minplus_forward_streamed
    with pytest.raises(TypeError, match="candidates"):
        fwd(cand.long(), node, counts, ploidy=3, **KW)
    with pytest.raises(TypeError, match="node_costs"):
        fwd(cand, node.double(), counts, ploidy=3, **KW)
    with pytest.raises(ValueError, match="last dim 6"):
        fwd(cand[..., :4].contiguous(), node, counts, ploidy=3, **KW)
    with pytest.raises(ValueError, match="disagree"):
        fwd(cand[:, :3].contiguous(), node, counts, ploidy=3, **KW)
    with pytest.raises(ValueError, match="counts table"):
        fwd(cand, node[..., :55].contiguous(), counts, ploidy=3, **KW)
    with pytest.raises(ValueError, match="counts table"):
        fwd(cand, node, full_state_counts(2), ploidy=3, **KW)
    with pytest.raises(ValueError, match="contiguous"):
        fwd(cand, node.transpose(0, 1).contiguous().transpose(0, 1),
            counts, ploidy=3, **KW)
    bt = ms.backtrace_streamed
    with pytest.raises(TypeError, match="final_state"):
        bt(torch.zeros((2, 4, 56), dtype=torch.int32),
           torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="does not match"):
        bt(torch.zeros((2, 4, 56), dtype=torch.int32),
           torch.zeros(3, dtype=torch.int32))


def test_packed_counts_layout():
    counts = full_state_counts(5)                     # [2002, 10]
    packed = ms.packed_counts(counts)
    assert packed.shape == (2002, 3) and packed.dtype == np.int32
    words = packed.astype(np.int64) & 0xFFFFFFFF
    for m in range(10):
        got = (words[:, m // 4] >> (8 * (m % 4))) & 0xFF
        np.testing.assert_array_equal(got, counts[:, m])
    assert not (words[:, 2] >> 16).any()              # padding bytes
    with pytest.raises(ValueError, match="0..255"):
        ms.packed_counts(np.full((2, 2), 300))


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_ge_planes_product_is_the_intersection(k):
    """The int8 0/1 plane table the CUDA kernel multiplies on the tensor
    cores: A @ B.T equals sum_m min(a_m, b_m) exactly, on the state
    counts against random mapped counts in 0..k."""
    rng = np.random.default_rng(k)
    counts = full_state_counts(k)
    mapped = rng.integers(0, k + 1, size=(97, 2 * k))
    A = ms.ge_planes(counts, k).astype(np.int32)
    B = ms.ge_planes(mapped, k).astype(np.int32)
    assert A.shape == (counts.shape[0], ms.plane_bytes(k))
    assert ms.plane_bytes(k) % 32 == 0 and ms.plane_bytes(k) >= 2 * k * k
    assert set(np.unique(A)) <= {0, 1}
    want = np.minimum(counts[:, None, :], mapped[None, :, :]).sum(-1)
    np.testing.assert_array_equal(A @ B.T, want)
    # byte kk belongs to lane q = kk % 16 // 4 of an mma.m16n8k32
    # fragment, which holds the planes of slots q, q+4, q+8 only
    for kk in range(ms.plane_bytes(k)):
        q = kk % 16 // 4
        assert not A[:, kk].any() or any(
            np.array_equal(A[:, kk], counts[:, m] >= u)
            for m in range(q, 2 * k, 4) for u in range(1, k + 1))
    with pytest.raises(ValueError, match="0..2"):
        ms.ge_planes(np.full((1, 4), 3), 2)


@pytest.mark.parametrize("C,S,want", [
    (20, 330, 4),       # config3c's group: 20 clusters of 4 CTAs
    (1, 330, 16),       # one tetraploid chain: 16 CTAs of 21 states
    (1000, 330, 1),     # many chains: one CTA a chain
    (4, 2002, 16),      # k=5, few chains: the largest cluster
    (37, 56, 1),        # k=3: 56 x 28 cells a CTA are too few to split
    (40, 330, 2)])      # 40 chains: 80 of the 132 SMs
def test_choose_cluster(C, S, want):
    """On an H100 (132 SMs, 132 // G clusters of G CTAs resident)."""
    assert ms.choose_cluster(C, S, 132, lambda g: 132 // g) == want


def test_choose_cluster_respects_occupancy():
    """A cluster size of which fewer than C clusters fit at once on the
    card is not taken."""
    assert ms.choose_cluster(8, 330, 132, lambda g: 7 if g == 16
                             else 132 // g) == 8
    assert ms.choose_cluster(20, 330, 40, lambda g: 40 // g) == 2


def test_cluster_argument_checks():
    counts = full_state_counts(4)
    cand = torch.zeros((2, 4, 8), dtype=torch.int32)
    node = torch.zeros((2, 4, 330))
    # a CPU tensor takes the plain version
    fin, _ = ms.minplus_forward_streamed(cand, node, counts, ploidy=4, **KW)
    assert fin.shape == (2, 330)
    assert ms.cluster_size(5, 10, 2, "cpu") == 1
    # the kernel's launcher takes the cluster sizes of CLUSTER_SIZES (1 at
    # ploidy <= 2) and CUDA tensors only: a CPU tensor never reaches it
    with pytest.raises(ValueError, match="3 CTAs"):
        ms._forward(cand, node, counts, 4, 3, **KW)
    with pytest.raises(ValueError, match="2 CTAs"):
        ms._forward(cand[:, :, :4], node[:, :, :10], full_state_counts(2),
                    2, 2, **KW)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ms._forward(cand, node, counts, 4, 16, **KW)
