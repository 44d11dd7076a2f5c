"""The port's DP-input building (whole-array numpy) against the JAX
package's per-position loop, byte for byte with dtypes: candidate
selection, aligned coverage, consensus and genotypes, over seeded count
tables that force coverage ties, positions with fewer covering clusters
than the ploidy, clusters under the cutoff past slot ``ploidy``, unused
cluster ids and empty allele counts; the dense-matrix route (R = 0
included), the ReadSet route, and the per-read cluster assignment."""

import dataclasses

import numpy as np
import pytest

from ahsoka_tpu import config as jconfig
from ahsoka_tpu.cluster import editing as jediting
from ahsoka_tpu.cluster import postprocess as jpost
from ahsoka_tpu.project import readset as jreadset
from ahsoka_tpu_torch import config as tconfig
from ahsoka_tpu_torch.cluster import editing as tediting
from ahsoka_tpu_torch.cluster import postprocess as tpost
from ahsoka_tpu_torch.project import readset as treadset

from test_torch_cuda import tetraploid_matrix

PRIORS = ["reference", "balanced"]


def plain(dp):
    """Field by field: dtype, shape and bytes of every array."""
    return {f.name: (getattr(dp, f.name).dtype.str,
                     getattr(dp, f.name).shape,
                     getattr(dp, f.name).tobytes())
            for f in dataclasses.fields(dp)}


def _configs(ploidy, prior):
    # ploidy 6 takes the beam DP (a config check; the DP does not run)
    kw = dict(ploidy=ploidy, genotype_prior=prior,
              dp_beam_width=2048 if ploidy >= 6 else 0)
    return jconfig.PhasingConfig(**kw), tconfig.PhasingConfig(**kw)


def _counts(seed, ploidy, P=60, K=40, A=4):
    """[P, K] coverage and [P, K, A] allele counts: small counts (ties in
    relative coverage), unused clusters, thinly covered positions, and
    positions one cluster dominates (the rest under the cutoff)."""
    rng = np.random.default_rng(seed)
    cov = rng.integers(0, 3, size=(P, K)) * (rng.random((P, K)) < 0.4)
    cov[:, rng.choice(K, size=K // 5, replace=False)] = 0
    thin = rng.random(P) < 0.25
    for j in np.nonzero(thin)[0]:
        keep = rng.choice(K, size=max(ploidy - 1, 0), replace=False)
        row = np.zeros(K, dtype=cov.dtype)
        row[keep] = cov[j, keep]
        cov[j] = row
    heavy = (~thin) & (rng.random(P) < 0.3)
    cov[heavy, rng.integers(0, K, size=int(heavy.sum()))] = 200
    allele = np.zeros((P, K, A), dtype=np.int64)
    for (j, k) in zip(*np.nonzero(cov)):
        allele[j, k] = rng.multinomial(cov[j, k], [1.0 / A] * A)
    allele[rng.random((P, K)) < 0.05] = 0        # no allele counted
    positions = np.arange(P, dtype=np.int32) * 3 + 1
    return positions, cov.astype(np.int64), allele


@pytest.mark.parametrize("prior", PRIORS)
@pytest.mark.parametrize("ploidy", [1, 2, 3, 4, 5, 6])
def test_dp_inputs_from_counts_equal(ploidy, prior):
    positions, cov, allele = _counts(ploidy, ploidy)
    jcfg, tcfg = _configs(ploidy, prior)
    want = jpost._dp_inputs_from_counts(positions, cov, allele, jcfg)
    got = tpost._dp_inputs_from_counts(positions, cov, allele, tcfg)
    assert plain(got) == plain(want)
    # the cases the table is built to hold are there
    covering = (cov > 0).sum(axis=1)
    assert (covering[covering > 0] < ploidy).any() or ploidy == 1
    assert (want.num_candidates < np.minimum(covering, 2 * ploidy)).any()
    rel = cov / np.maximum(cov.sum(axis=1, keepdims=True), 1)
    assert any(len(set(r[r > 0])) < (r > 0).sum() for r in rel)
    assert (cov.sum(axis=0) == 0).any()


@pytest.mark.parametrize("prior", PRIORS)
@pytest.mark.parametrize("ploidy,R", [(2, 0), (4, 0), (2, 90), (4, 90)])
def test_dp_inputs_from_matrix_equal(ploidy, R, prior):
    m = tetraploid_matrix(R + ploidy, max(R, 1), 30)
    rng = np.random.default_rng(R)
    cluster_of = rng.integers(0, 12, size=R).astype(np.int32)
    jcfg, tcfg = _configs(ploidy, prior)
    want = jpost.build_dp_inputs_from_matrix(m.alleles[:R], m.positions,
                                             cluster_of, jcfg)
    got = tpost.build_dp_inputs_from_matrix(m.alleles[:R], m.positions,
                                            cluster_of, tcfg)
    assert plain(got) == plain(want)
    assert tpost.consensus_lookup(got) == jpost.consensus_lookup(want)


def _readsets(m):
    out = []
    for mod in (jreadset, treadset):
        rs = mod.ReadSet()
        for r in range(m.num_reads):
            cols = np.nonzero(m.alleles[r] >= 0)[0]
            rs.add(mod.Read(name=m.read_names[r], mapq=60,
                            positions=[int(m.positions[c]) for c in cols],
                            alleles=[int(m.alleles[r, c]) for c in cols]))
        out.append(rs)
    return out


@pytest.mark.parametrize("ploidy", [2, 4])
def test_build_dp_inputs_readset_route_equal(ploidy):
    m = tetraploid_matrix(7 + ploidy, 80, 25)
    jrs, trs = _readsets(m)
    rng = np.random.default_rng(ploidy)
    cluster_of = rng.integers(0, 15, size=m.num_reads)
    # empty clusters keep unused ids
    clusters = [np.nonzero(cluster_of == c)[0].tolist() for c in range(18)]
    jcfg, tcfg = _configs(ploidy, "balanced")
    want = jpost.build_dp_inputs(jrs, clusters, jcfg)
    got = tpost.build_dp_inputs(trs, clusters, tcfg)
    assert plain(got) == plain(want)


@pytest.mark.parametrize("seed", [0, 1])
def test_assignment_from_clusters_equal(seed):
    """Reads in no cluster stay -1; empty clusters keep their ids."""
    rng = np.random.default_rng(seed)
    R = 70
    cluster_of = rng.integers(-1, 9, size=R)
    clusters = [np.nonzero(cluster_of == c)[0].tolist() for c in range(11)]
    got = tediting.assignment_from_clusters(clusters, R)
    want = jediting.assignment_from_clusters(clusters, R)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert tediting.assignment_from_clusters([], 0).tobytes() == \
        jediting.assignment_from_clusters([], 0).tobytes()
