"""The port's DP oracles and small utilities on the CPU against the JAX
package, on the same seeded inputs: the native sequential DP
(``thread/_native_dp.py``), the log-depth associative-scan DP
(``thread/dp_assoc.py``), ``thread_and_assign_device``, and
``utils/editdist.py`` / ``utils/kmers.py``."""

import numpy as np
import pytest
import torch

from ahsoka_tpu.config import PhasingConfig
from ahsoka_tpu.thread.dp_host import thread_chain
from ahsoka_tpu.thread.states import (full_state_counts, full_state_validity,
                                      state_tuples)

from test_dp import _path_cost, random_dp_inputs

torch.set_num_threads(1)


def _sorted(path):
    return [tuple(sorted(t)) for t in path]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("ploidy", [2, 3, 4])
def test_native_dp_matches_host_and_port(seed, ploidy):
    """The port's build of native/dp_baseline.cpp threads the same paths
    (as sorted tuples) as the JAX package's numpy ``dp_host.thread_chain``
    and the port's ``thread_chains_batched`` on the CPU."""
    from ahsoka_tpu_torch.thread._native_dp import (native_dp_available,
                                                    run_native_dp)
    from ahsoka_tpu_torch.thread.dp_torch import thread_chains_batched

    assert native_dp_available()
    cfg = PhasingConfig(ploidy=ploidy)
    dp = random_dp_inputs(P=10, ploidy=ploidy, num_clusters=2 * ploidy + 1,
                          seed=seed)
    cells, states = run_native_dp(dp.candidates, dp.num_candidates,
                                  dp.coverage, dp.consensus,
                                  dp.genotypes.astype(np.float32), ploidy,
                                  cfg.switch_cost, cfg.affine_switch_cost)
    tuples = state_tuples(2 * ploidy, ploidy)
    assert cells == (10 - 1) * len(tuples) ** 2
    native = [tuple(int(dp.candidates[j, s]) for s in tuples[int(st)])
              for j, st in enumerate(states)]
    assert _sorted(native) == _sorted(thread_chain(dp, cfg))
    assert _sorted(native) == \
        _sorted(thread_chains_batched([dp], cfg, device="cpu")[0])


def test_native_dp_build_failure_raises(monkeypatch):
    from ahsoka_tpu_torch.thread import _native_dp

    def failed(*a, **k):
        raise RuntimeError("build of libahsoka_dp.so failed")

    monkeypatch.setattr(_native_dp, "_lib", None)
    monkeypatch.setattr(_native_dp, "load_native", failed)
    with pytest.raises(RuntimeError, match="build"):
        _native_dp.native_dp_available()


def _jax_assoc(dp, cfg):
    import jax.numpy as jnp

    from ahsoka_tpu.thread.dp_assoc import _assoc_forward

    k = cfg.ploidy
    fwd, T = _assoc_forward(
        jnp.asarray(dp.candidates), jnp.asarray(dp.num_candidates),
        jnp.asarray(dp.coverage, dtype=jnp.float32),
        jnp.asarray(dp.consensus),
        jnp.asarray(dp.genotypes, dtype=jnp.float32),
        jnp.asarray(full_state_counts(k)),
        jnp.asarray(full_state_validity(k)), ploidy=k,
        num_alleles=dp.genotypes.shape[1],
        switch_cost=jnp.float32(cfg.switch_cost),
        affine_cost=jnp.float32(cfg.affine_switch_cost),
        cov_w=jnp.float32(cfg.coverage_cost_weight),
        geno_w=jnp.float32(cfg.genotype_cost_weight))
    return np.asarray(fwd), np.asarray(T)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("ploidy,P", [(2, 12), (2, 37), (3, 9)])
def test_assoc_matches_jax_and_sequential_cost(seed, ploidy, P):
    """Forward costs within rtol 1e-5 of JAX ``_assoc_forward`` (another
    association order of the float32 sums), transitions exactly equal, and
    the path's cost equal to the sequential optimum within rtol 1e-5."""
    from ahsoka_tpu_torch.state import to_torch
    from ahsoka_tpu_torch.thread.dp_assoc import (_assoc_forward,
                                                  thread_chain_assoc)

    cfg = PhasingConfig(ploidy=ploidy)
    dp = random_dp_inputs(P=P, ploidy=ploidy, num_clusters=2 * ploidy + 1,
                          seed=seed)
    fwd_j, T_j = _jax_assoc(dp, cfg)
    fwd, T = _assoc_forward(
        *to_torch(dp.candidates, dp.num_candidates, dp.coverage,
                  dp.consensus, dp.genotypes.astype(np.float32),
                  device="cpu"),
        full_state_counts(ploidy), full_state_validity(ploidy),
        ploidy=ploidy, num_alleles=dp.genotypes.shape[1],
        switch_cost=cfg.switch_cost, affine_cost=cfg.affine_switch_cost,
        cov_w=cfg.coverage_cost_weight, geno_w=cfg.genotype_cost_weight)
    np.testing.assert_array_equal(T.numpy(), T_j)
    np.testing.assert_allclose(fwd.numpy(), fwd_j, rtol=1e-5, atol=0)
    assoc = thread_chain_assoc(dp, cfg, device="cpu")
    assert _path_cost(dp, assoc, cfg) == \
        pytest.approx(_path_cost(dp, thread_chain(dp, cfg), cfg), rel=1e-5)


def test_assoc_scan_is_log_depth(monkeypatch):
    """ceil(log2(P - 1)) rounds of batched min-plus products, each over
    every prefix at once."""
    from ahsoka_tpu_torch.thread import dp_assoc

    calls = []
    real = dp_assoc._minplus_matmul

    def spy(a, b):
        calls.append(a.shape[0])
        return real(a, b)

    monkeypatch.setattr(dp_assoc, "_minplus_matmul", spy)
    cfg = PhasingConfig(ploidy=2)
    dp = random_dp_inputs(P=41, ploidy=2, num_clusters=5, seed=1)
    path = dp_assoc.thread_chain_assoc(dp, cfg, device="cpu")
    assert calls == [39, 38, 36, 32, 24, 8]
    assert _path_cost(dp, path, cfg) == \
        pytest.approx(_path_cost(dp, thread_chain(dp, cfg), cfg), rel=1e-5)


@pytest.mark.parametrize("ploidy,beam", [(2, 0), (3, 0), (4, 0), (4, 16)])
def test_thread_and_assign_device_matches_jax(ploidy, beam):
    from ahsoka_tpu.thread.dp_jax import thread_and_assign_device as jax_taa
    from ahsoka_tpu_torch.thread.dp_torch import thread_and_assign_device

    cfg = PhasingConfig(ploidy=ploidy, dp_beam_width=beam)
    for seed in range(2):
        dp = random_dp_inputs(P=14, ploidy=ploidy,
                              num_clusters=2 * ploidy + 1, seed=seed)
        assert thread_and_assign_device(dp, cfg, device="cpu") == \
            jax_taa(dp, cfg)


def _random_strings(seed, n, alphabet, max_len):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(list(alphabet),
                               size=int(rng.integers(0, max_len + 1))))
            for _ in range(n)]


@pytest.mark.parametrize("seed", range(3))
def test_edit_distance_matches_jax(seed):
    from ahsoka_tpu.utils.editdist import edit_distance as jax_ed
    from ahsoka_tpu_torch.utils.editdist import edit_distance

    strings = _random_strings(seed, 24, "ACGT", 30)
    for a, b in zip(strings, strings[1:] + strings[:1]):
        assert edit_distance(a, b) == jax_ed(a, b)
    assert edit_distance("kitten", "sitting") == 3


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("k", [1, 3, 5])
def test_kmers_match_jax(seed, k):
    from ahsoka_tpu.utils import kmers as jax_kmers
    from ahsoka_tpu_torch.utils import kmers

    for seq in _random_strings(seed, 12, "ACGTNacgt", 60):
        assert list(kmers.canonical_kmers(seq, k)) == \
            list(jax_kmers.canonical_kmers(seq, k))
        assert kmers.kmer_counts(seq, k) == jax_kmers.kmer_counts(seq, k)
        assert kmers.reverse_complement(seq.upper()) == \
            jax_kmers.reverse_complement(seq.upper())
