"""The port's host layer (``ahsoka_tpu_torch``'s copies of the JAX
package's host modules) against the JAX package, on the same inputs.

The JAX side runs its pure-Python oracles (Python GFA/GAF parsers, the
unordered_map simulator, the Python cluster-editing and coverage-cap
engines): its native helpers are marked unavailable for these tests, so
they never build them, and the port's native helpers (built under a lock
into build/ahsoka_tpu_torch/native/) are held to those oracles exactly.
Comparisons are exact: the host layer is integer and float64 numpy code
that the port copied, so any difference is a porting error.
"""

import dataclasses
import io
import multiprocessing as mp
import os
import shutil

import numpy as np
import pytest
import torch

from ahsoka_tpu import config as jconfig
from ahsoka_tpu.cli.main import build_parser as jax_parser
from ahsoka_tpu.cluster import editing as jediting
from ahsoka_tpu.cluster import postprocess as jpost
from ahsoka_tpu.emit import bubbleinfo as jbubbleinfo
from ahsoka_tpu.emit import result as jresult
from ahsoka_tpu.graph import alleles as jalleles
from ahsoka_tpu.graph import bubbles as jbubbles
from ahsoka_tpu.io import columns as jcolumns
from ahsoka_tpu.io import gaf as jgaf
from ahsoka_tpu.io import gfa as jgfa
from ahsoka_tpu.project import collapse as jcollapse
from ahsoka_tpu.project import readset as jreadset
from ahsoka_tpu.project import subsample as jsubsample
from ahsoka_tpu.score import pairwise as jpairwise
from ahsoka_tpu.score import whatshap as jwhatshap
from ahsoka_tpu.thread import dp_host as jdp_host
from ahsoka_tpu.thread import states as jstates
from ahsoka_tpu.utils import accuracy as jaccuracy
from ahsoka_tpu.utils import synth as jsynth
from ahsoka_tpu_torch import config as tconfig
from ahsoka_tpu_torch.cli.main import build_parser as torch_parser
from ahsoka_tpu_torch.cluster import _native_ce as tnative_ce
from ahsoka_tpu_torch.cluster import editing as tediting
from ahsoka_tpu_torch.cluster import postprocess as tpost
from ahsoka_tpu_torch.emit import bubbleinfo as tbubbleinfo
from ahsoka_tpu_torch.emit import result as tresult
from ahsoka_tpu_torch.graph import alleles as talleles
from ahsoka_tpu_torch.graph import bubbles as tbubbles
from ahsoka_tpu_torch.io import columns as tcolumns
from ahsoka_tpu_torch.io import gaf as tgaf
from ahsoka_tpu_torch.io import gfa as tgfa
from ahsoka_tpu_torch.project import collapse as tcollapse
from ahsoka_tpu_torch.project import readset as treadset
from ahsoka_tpu_torch.project import subsample as tsubsample
from ahsoka_tpu_torch.score import pairwise as tpairwise
from ahsoka_tpu_torch.score import whatshap as twhatshap
from ahsoka_tpu_torch.thread import dp_host as tdp_host
from ahsoka_tpu_torch.thread import states as tstates
from ahsoka_tpu_torch.utils import accuracy as taccuracy
from ahsoka_tpu_torch.utils import synth as tsynth

from test_dp import random_dp_inputs

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@pytest.fixture(autouse=True)
def _jax_python_oracles(monkeypatch):
    """The JAX package's native loaders report themselves unavailable, so
    its Python engines answer (and nothing builds into ahsoka_tpu/)."""
    from ahsoka_tpu.cluster import _native_ce
    from ahsoka_tpu.compat import _native
    from ahsoka_tpu.io import _native_io
    from ahsoka_tpu.project import _native_covcap
    monkeypatch.setattr(_native, "_load_failed", True)
    monkeypatch.setattr(_native, "_lib", None)
    for mod in (_native_ce, _native_io, _native_covcap):
        monkeypatch.setattr(mod, "_failed", True)
        monkeypatch.setattr(mod, "_lib", None)


def plain(obj):
    """Package-neutral form of a host object (dataclasses, ReadSets,
    numpy arrays) for equality across the two packages."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, np.ndarray):
        return ("ndarray", obj.dtype.str, obj.shape, obj.tobytes())
    if isinstance(obj, dict):
        return {plain(k): plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return tuple(plain(v) for v in obj)
    if isinstance(obj, (set, frozenset)):
        return tuple(sorted(plain(v) for v in obj))
    if hasattr(obj, "reads") and hasattr(obj, "to_debug_string"):
        return ("ReadSet", tuple(plain(r) for r in obj.reads))
    if isinstance(obj, (np.integer, np.floating)):
        return obj.item()
    return obj


# ------------------------------------------------------------- configuration
JAX_FIELDS = [f.name for f in dataclasses.fields(jconfig.PhasingConfig)]


def test_config_has_the_same_fields():
    assert [f.name for f in dataclasses.fields(tconfig.PhasingConfig)] \
        == JAX_FIELDS


@pytest.mark.parametrize("field", JAX_FIELDS)
def test_config_field_default_equal(field):
    assert getattr(tconfig.PhasingConfig(), field) == \
        getattr(jconfig.PhasingConfig(), field)


def _options(parser):
    import argparse
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return {name: {a.option_strings[0] if a.option_strings else a.dest:
                   (a.dest, a.default, a.choices, a.type, a.required,
                    a.nargs, a.const)
                   for a in sp._actions}
            for name, sp in sub.choices.items()}


@pytest.mark.parametrize("command", ["phase", "only-bubbles"])
def test_cli_parsers_accept_the_same_options(command):
    port, ref = _options(torch_parser()), _options(jax_parser())
    assert set(port) == set(ref)
    extra = {"--device"} if command == "phase" else set()
    assert set(port[command]) == set(ref[command]) | extra
    for opt, spec in ref[command].items():
        assert port[command][opt] == spec, opt


# ------------------------------------------------------------------ inputs
SPECS = {
    "synth_diploid": dict(num_chains=5, bubbles_per_chain=9,
                          reads_per_hap=14, span=3, error_rate=0.05, seed=4),
    "synth_mixed": dict(chain_plan=[(8, 2), (7, 3), (6, 4)], span=3,
                        coverage_per_hap=6.0, error_rate=0.03, seed=7),
}
CASES = ["golden_diploid", "golden_tetra", "synth_diploid", "synth_mixed"]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """name -> (gfa path, gaf path, truth path or None), the goldens
    copied and the synthetic inputs written by the JAX package."""
    root = tmp_path_factory.mktemp("host_inputs")
    out = {}
    for name in ("golden_diploid", "golden_tetra"):
        gfa, gaf = (str(root / f"{name}.{x}") for x in ("gfa", "gaf"))
        shutil.copy(os.path.join(DATA, f"{name}.gfa"), gfa)
        shutil.copy(os.path.join(DATA, f"{name}.gaf"), gaf)
        out[name] = (gfa, gaf, None)
    for name, kw in SPECS.items():
        paths = [str(root / f"{name}.{x}") for x in ("gfa", "gaf", "truth")]
        jsynth.write_synthetic(paths[0], paths[1], jsynth.SynthSpec(**kw),
                               truth_path=paths[2])
        out[name] = tuple(paths)
    return out


def _lines(path):
    with open(path) as fh:
        return fh.readlines()


@pytest.mark.parametrize("name", list(SPECS))
def test_synth_writes_the_same_files(tmp_path, name):
    files = {}
    for tag, mod in (("jax", jsynth), ("port", tsynth)):
        paths = [str(tmp_path / f"{tag}.{x}") for x in ("gfa", "gaf",
                                                         "truth")]
        mod.write_synthetic(paths[0], paths[1], mod.SynthSpec(**SPECS[name]),
                            truth_path=paths[2])
        files[tag] = [open(p, "rb").read() for p in paths]
    assert files["port"] == files["jax"]
    assert list(tsynth.CONFIGS) == list(jsynth.CONFIGS)
    assert all(plain(tsynth.CONFIGS[k]) == plain(jsynth.CONFIGS[k])
               for k in jsynth.CONFIGS)


def _graphs(inputs, name):
    gfa = inputs[name][0]
    jg = jgfa.parse_gfa(_lines(gfa), engine="python")
    return jg, tgfa.parse_gfa(gfa), jbubbles.find_bubbles(jg)


@pytest.mark.parametrize("name", CASES)
def test_gfa_parse_equal(inputs, name):
    """The port's native parser (a path) against the JAX Python parser."""
    jg, tg, _ = _graphs(inputs, name)
    assert plain(tg) == plain(jg)
    assert plain(tgfa.parse_gfa(_lines(inputs[name][0]))) == plain(jg)


@pytest.mark.parametrize("name", CASES)
def test_bubbles_and_allele_paths_equal(inputs, name):
    jg, tg, jindex = _graphs(inputs, name)
    tindex = tbubbles.find_bubbles(tg)
    assert plain(tindex) == plain(jindex)
    assert plain(talleles.enumerate_allele_paths(tg, tindex)) == \
        plain(jalleles.enumerate_allele_paths(jg, jindex))


@pytest.mark.parametrize("name", CASES)
def test_bubbleinfo_text_equal(inputs, name):
    jg, tg, jindex = _graphs(inputs, name)
    a, b = io.StringIO(), io.StringIO()
    jbubbleinfo.write_bubbleinfo(jindex, a)
    tbubbleinfo.write_bubbleinfo(tbubbles.find_bubbles(tg), b)
    assert b.getvalue() == a.getvalue()


@pytest.mark.parametrize("name", CASES)
def test_gaf_objects_and_identities_equal(inputs, name):
    """The port's Python and native GAF readers against the JAX Python
    one: chain buckets and the identities side file.  The native parser
    keeps identities as float32 (in both packages)."""
    _, tg, jindex = _graphs(inputs, name)
    tindex = tbubbles.find_bubbles(tg)
    gaf = inputs[name][1]
    a, b, c = io.StringIO(), io.StringIO(), io.StringIO()
    jt = jgaf.read_gaf(_lines(gaf), jindex, identities_out=a,
                       engine="python")
    tt = tgaf.read_gaf(_lines(gaf), tindex, identities_out=b,
                       engine="python")
    assert plain(tt) == plain(jt)
    assert b.getvalue() == a.getvalue()

    def f32(table):
        return {cid: [dataclasses.replace(al, identity=float(
                    np.float32(al.identity))) for al in als]
                for cid, als in table.by_chain.items()}

    tn = tgaf.read_gaf(gaf, tindex, identities_out=c)
    assert tn.num_records == jt.num_records
    assert plain(f32(tn)) == plain(f32(jt))
    assert c.getvalue() == a.getvalue()


@pytest.mark.parametrize("name", CASES)
def test_gaf_columns_and_buckets_equal(inputs, name):
    """Columnar GAF (the port's native parser) against columns built from
    the JAX package's Python records, bucketed by chain."""
    _, tg, jindex = _graphs(inputs, name)
    gaf = inputs[name][1]
    jt = jgaf.read_gaf(_lines(gaf), jindex, engine="python")
    records = sorted({a.order: a for als in jt.by_chain.values()
                      for a in als}.values(), key=lambda a: a.order)
    jcols = jcolumns.columns_from_alignments(records)
    tcols = tcolumns.read_gaf_columns(gaf)
    for field in ("node_ids", "node_dirs", "path_offsets", "starts", "ends",
                  "identities"):
        np.testing.assert_array_equal(getattr(tcols, field),
                                      getattr(jcols, field))
    assert [tcols.names[i] for i in tcols.record_name] == \
        [jcols.names[i] for i in jcols.record_name]
    tb = tcolumns.bucket_by_chain(tcols, tbubbles.find_bubbles(tg))
    jb = jcolumns.bucket_by_chain(tcols, jindex)
    assert plain(tb) == plain(jb)


# --------------------------------------------------------------- per chain
def _chains(inputs, name, ploidy):
    """[(chain id, JAX readsets, port readsets, JAX config, port config)]
    of every chain with more than one bubble and some reads."""
    jg, tg, jindex = _graphs(inputs, name)
    gaf = inputs[name][1]
    jt = jgaf.read_gaf(_lines(gaf), jindex, engine="python")
    tindex = tbubbles.find_bubbles(tg)
    tt = tgaf.read_gaf(gaf, tindex)
    jpaths = jalleles.enumerate_allele_paths(jg, jindex)
    tpaths = talleles.enumerate_allele_paths(tg, tindex)
    jcfg = jconfig.PhasingConfig(ploidy=ploidy)
    tcfg = tconfig.PhasingConfig(ploidy=ploidy)
    out = []
    for chain_id in sorted(jpaths):
        if len(jpaths[chain_id]) <= 1 or not jt.chain_alignments(chain_id):
            continue
        jr = jreadset.build_chain_readsets(jpaths[chain_id],
                                           jt.chain_alignments(chain_id),
                                           jcfg)
        tr = treadset.build_chain_readsets(tpaths[chain_id],
                                           tt.chain_alignments(chain_id),
                                           tcfg)
        out.append((chain_id, jr, tr, jcfg, tcfg))
    assert out
    return out


PLOIDY = {"golden_diploid": 2, "golden_tetra": 4, "synth_diploid": 2,
          "synth_mixed": 3}


@pytest.mark.parametrize("name", CASES)
def test_readsets_equal(inputs, name):
    for _, jr, tr, _, _ in _chains(inputs, name, PLOIDY[name]):
        assert plain(tr) == plain(jr)
        assert tr.partial_filtered.to_debug_string() == \
            jr.partial_filtered.to_debug_string()


def _matrix_pair(jr, tr):
    return (jpairwise.readset_to_matrix(jr.partial_filtered),
            tpairwise.readset_to_matrix(tr.partial_filtered))


@pytest.mark.parametrize("name", CASES)
def test_matrix_collapse_and_subsample_equal(inputs, name):
    for _, jr, tr, _, _ in _chains(inputs, name, PLOIDY[name]):
        jm, tm = _matrix_pair(jr, tr)
        assert plain(tm) == plain(jm)
        assert plain(tcollapse.collapse_reads(tm)) == \
            plain(jcollapse.collapse_reads(jm))
        for cap in (2, 5):
            ts, tk = tsubsample.subsample_matrix(tm, cap)
            js, jk = jsubsample.subsample_matrix(jm, cap)
            np.testing.assert_array_equal(tk, jk)
            assert plain(ts) == plain(js)


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("mode", ["whatshap", "fresh"])
def test_scoring_statistics_equal(inputs, name, mode):
    """whatshap p_s and per-position p_d, and the host pair scores."""
    for _, jr, tr, jcfg, tcfg in _chains(inputs, name, PLOIDY[name]):
        jm, tm = _matrix_pair(jr, tr)
        jcfg = dataclasses.replace(jcfg, score_mode=mode)
        tcfg = dataclasses.replace(tcfg, score_mode=mode)
        p_s = jwhatshap.chain_p_s(jm, jcfg)
        assert twhatshap.chain_p_s(tm, tcfg) == p_s
        np.testing.assert_array_equal(twhatshap.position_pd(tm, tcfg, p_s),
                                      jwhatshap.position_pd(jm, jcfg, p_s))
        np.testing.assert_array_equal(tpairwise.score_pairs(tm, tcfg),
                                      jpairwise.score_pairs(jm, jcfg))


@pytest.mark.parametrize("name", CASES)
def test_dp_inputs_equal(inputs, name):
    for _, jr, tr, jcfg, tcfg in _chains(inputs, name, PLOIDY[name]):
        jm, tm = _matrix_pair(jr, tr)
        clusters = jediting.cluster_editing(
            jpairwise.score_pairs(jm, jcfg), prefer_native=False)
        cluster_of = jediting.assignment_from_clusters(clusters,
                                                       jm.num_reads)
        np.testing.assert_array_equal(
            tediting.assignment_from_clusters(clusters, tm.num_reads),
            cluster_of)
        jd = jpost.build_dp_inputs_from_matrix(jm.alleles, jm.positions,
                                               cluster_of, jcfg)
        td = tpost.build_dp_inputs_from_matrix(tm.alleles, tm.positions,
                                               cluster_of, tcfg)
        assert plain(td) == plain(jd)
        assert tpost.consensus_lookup(td) == jpost.consensus_lookup(jd)


# ---------------------------------------------------------- cluster editing
def _weights(n, seed):
    """Symmetric read-similarity weights: three planted groups, noise,
    and zeros (absent edges) for the sparse solver."""
    rng = np.random.default_rng(seed)
    group = rng.integers(0, 3, size=n)
    w = np.where(group[:, None] == group[None, :], 2.0, -2.0)
    w = w + rng.normal(0.0, 1.5, size=(n, n))
    w = np.where(rng.random((n, n)) < 0.3, 0.0, w)
    w = np.triu(w, 1)
    return w + w.T


@pytest.mark.parametrize("n,seed", [(80, 0), (150, 1)])
@pytest.mark.parametrize("mode", ["whatshap", "fresh"])
def test_native_cluster_editing_dense_equals_oracle(n, seed, mode):
    w = _weights(n, seed)
    assert tediting.cluster_editing(w, mode=mode) == \
        jediting._host_cluster_editing(w, mode)


@pytest.mark.parametrize("n,seed", [(80, 2), (150, 3)])
@pytest.mark.parametrize("mode", ["whatshap", "fresh"])
def test_native_cluster_editing_sparse_equals_oracle(n, seed, mode):
    """The sparse solver with exact priorities reproduces the dense
    oracle's decisions."""
    w = _weights(n, seed)
    iu = np.triu_indices(n, k=1)
    keep = w[iu] != 0
    got = tnative_ce.cluster_editing_sparse(
        n, iu[0][keep], iu[1][keep], w[iu][keep], exact_priorities=True,
        mode=mode)
    assert got == jediting._host_cluster_editing(w, mode)


# ------------------------------------------------- emission, states, DP host
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6])
def test_state_tables_equal(k):
    np.testing.assert_array_equal(tstates.full_state_counts(k),
                                  jstates.full_state_counts(k))
    np.testing.assert_array_equal(tstates.full_state_validity(k),
                                  jstates.full_state_validity(k))
    assert tstates.max_states(k) == jstates.max_states(k)
    assert tstates.state_tuples(2 * k, k) == jstates.state_tuples(2 * k, k)


@pytest.mark.parametrize("k,seed", [(2, 0), (3, 1), (4, 2)])
def test_host_threading_equal(k, seed):
    dp = random_dp_inputs(P=9, ploidy=k, num_clusters=2 * k + 1, seed=seed)
    assert tdp_host.thread_and_assign(dp, tconfig.PhasingConfig(ploidy=k)) \
        == jdp_host.thread_and_assign(dp, jconfig.PhasingConfig(ploidy=k))


@pytest.mark.parametrize("name", CASES)
def test_emitted_result_text_equal(inputs, name, tmp_path):
    """Thread each chain with the JAX host DP, emit it through both
    packages' emitters: same haplotype alleles, result text and files."""
    k = PLOIDY[name]
    jg, tg, jindex = _graphs(inputs, name)
    jpaths = jalleles.enumerate_allele_paths(jg, jindex)
    tpaths = talleles.enumerate_allele_paths(tg, tbubbles.find_bubbles(tg))
    jcfg = jconfig.PhasingConfig(ploidy=k)
    texts = {}
    for tag, emit, graph, paths in (("jax", jresult, jg, jpaths),
                                    ("port", tresult, tg, tpaths)):
        buf, haps = io.StringIO(), []
        os.makedirs(tmp_path / tag)
        for chain_id, jr, _, _, _ in _chains(inputs, name, k):
            jm = jpairwise.readset_to_matrix(jr.partial_filtered)
            clusters = jediting.cluster_editing(
                jpairwise.score_pairs(jm, jcfg), prefer_native=False)
            dp = jpost.build_dp_inputs_from_matrix(
                jm.alleles, jm.positions,
                jediting.assignment_from_clusters(clusters, jm.num_reads),
                jcfg)
            haps.append(emit.emit_chain_result(
                graph=graph, chain_id=chain_id,
                hap_cluster_path=jdp_host.thread_and_assign(dp, jcfg),
                consensus_by_cluster=jpost.consensus_lookup(dp),
                dense_positions=[int(p) for p in dp.positions],
                bubble_paths=paths[chain_id], ploidy=k,
                outstem=str(tmp_path / tag / "o"), full_output=buf))
        files = {f: open(tmp_path / tag / f).read()
                 for f in sorted(os.listdir(tmp_path / tag))}
        texts[tag] = (haps, buf.getvalue(), files)
    assert texts["port"] == texts["jax"]


@pytest.mark.parametrize("name", ["synth_diploid", "synth_mixed"])
def test_planted_truth_accuracy_equal(inputs, name, tmp_path):
    """ploidy_map_from_truth and score_phased_output of both packages on
    the port's CPU phasing of a synthetic sample."""
    from ahsoka_tpu_torch.pipeline import run_phase
    gfa, gaf, truth = inputs[name]
    jg, tg, jindex = _graphs(inputs, name)
    tpaths = talleles.enumerate_allele_paths(tg, tbubbles.find_bubbles(tg))
    jpaths = jalleles.enumerate_allele_paths(jg, jindex)
    pmap = taccuracy.ploidy_map_from_truth(tpaths, truth)
    assert pmap == jaccuracy.ploidy_map_from_truth(jpaths, truth)
    work_gaf = str(tmp_path / "r.gaf")
    shutil.copy(gaf, work_gaf)
    out = str(tmp_path / "o")
    run_phase(gfa, work_gaf, out,
              tconfig.PhasingConfig(ploidy_map=pmap, threads=1),
              device="cpu")
    assert taccuracy.score_phased_output(out, truth) == \
        jaccuracy.score_phased_output(out, truth)


# ------------------------------------------------------------ native loaders
def _load_helpers(build_dir, start):
    """Child process: build and load the port's native cluster editing
    and coverage cap into ``build_dir`` once every sibling is ready, then
    run each once."""
    from ahsoka_tpu_torch.cluster import _native_ce
    from ahsoka_tpu_torch.project import _native_covcap
    from ahsoka_tpu_torch.utils import native
    native.NATIVE_BUILD = build_dir
    start.wait()
    w = np.array([[0.0, 1.0, -1.0], [1.0, 0.0, -1.0], [-1.0, -1.0, 0.0]])
    assert _native_ce.cluster_editing_native(w) == [[0, 1], [2]]
    keep = _native_covcap.native_covcap(np.array([0, 1]), np.array([0, 0]),
                                        2, 1, 1)
    assert keep.tolist() == [True, False]


def test_native_helpers_build_once_across_processes(tmp_path):
    """Four spawned processes load the port's native cluster editing and
    coverage cap into one empty build directory at once: the file lock
    and the atomic rename let every one of them succeed."""
    ctx = mp.get_context("spawn")
    start = ctx.Barrier(4)
    build_dir = str(tmp_path / "native")
    procs = [ctx.Process(target=_load_helpers, args=(build_dir, start))
             for _ in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=240)
    assert [p.exitcode for p in procs] == [0, 0, 0, 0]
    built = sorted(f for f in os.listdir(build_dir) if f.endswith(".so"))
    assert built == ["libahsoka_ce.so", "libahsoka_covcap.so"]
    assert not [f for f in os.listdir(build_dir) if f.endswith(".tmp")]


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A g++ failure raises with the compiler's output instead of marking
    the helper unavailable."""
    from ahsoka_tpu_torch.utils import native
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "NATIVE_SRC", str(tmp_path))
    monkeypatch.setattr(native, "NATIVE_BUILD", str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="build of libbad.so failed"):
        native.load_native("bad", ["bad.cpp"])
    assert not os.path.exists(tmp_path / "out" / "libbad.so")
