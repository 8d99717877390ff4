"""The port's evaluation tools (``rabbittclust_tpu_torch/evaltools/``)
against the JAX package's originals, on the inputs of
``tests/test_evaltools.py`` (a simulated corpus clustered by the CLI, a
``--newick-tree`` output) and on small synthetic inputs made from a seed:
return values equal, and each tool run as ``python -m <package>.evaltools.
<tool>`` with the same arguments writing the same bytes and printing the
same lines.  Also the malloc tuning run at import (``_tune_malloc``),
through a recorder in place of ``ctypes.CDLL``."""

import ctypes
import io
import itertools
import os
import random
import subprocess
import sys

import pytest
import torch

import rabbittclust_tpu
import rabbittclust_tpu_torch
from rabbittclust_tpu.evaltools import evaluate as jax_evaluate
from rabbittclust_tpu.evaltools import genus_analysis as jax_genus
from rabbittclust_tpu.evaltools import newick as jax_newick
from rabbittclust_tpu.evaltools import simulate as jax_simulate
from rabbittclust_tpu.evaltools import taxonomy as jax_taxonomy
from rabbittclust_tpu_torch.evaltools import evaluate as port_evaluate
from rabbittclust_tpu_torch.evaltools import genus_analysis as port_genus
from rabbittclust_tpu_torch.evaltools import newick as port_newick
from rabbittclust_tpu_torch.evaltools import simulate as port_simulate
from rabbittclust_tpu_torch.evaltools import taxonomy as port_taxonomy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
PACKAGES = {"jax": "rabbittclust_tpu", "port": "rabbittclust_tpu_torch"}
SEEDS = [3, 11, 29]


def _tool(side, tool, args, cwd):
    """Runs ``python -m <package>.evaltools.<tool> args``; returns its
    (exit code, stdout, stderr with the package's name taken out)."""
    mod = f"{PACKAGES[side]}.evaltools.{tool}"
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-m", mod, *args], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    return r.returncode, r.stdout, r.stderr.replace(PACKAGES[side], "PKG")


def _files(d):
    """{relative path: bytes} of every file under ``d``."""
    out = {}
    for root, _, names in os.walk(d):
        for name in names:
            p = os.path.join(root, name)
            with open(p, "rb") as f:
                out[os.path.relpath(p, d)] = f.read()
    return out


def _run_both(tmp_path, tool, make_args):
    """Runs the tool of both packages, each in a directory of its own
    (``make_args(out_dir)`` gives its arguments); asserts the same exit
    code, output lines and files (the directory's path read as OUT);
    returns the port's (stdout, files)."""
    res = {}
    for side in PACKAGES:
        out = tmp_path / f"{side}_out"
        out.mkdir(parents=True)
        rc, stdout, stderr = _tool(side, tool, make_args(str(out)), str(out))
        assert rc == 0, stderr[-2000:]
        files = {k: v.replace(str(out).encode(), b"OUT")
                 for k, v in _files(out).items()}
        res[side] = (rc, stdout.replace(str(out), "OUT"),
                     stderr.replace(str(out), "OUT"), files)
    assert res["port"] == res["jax"]
    return res["port"][1], res["port"][3]


# ---------------------------------------------------------------------------
# simulate


@pytest.mark.parametrize("mode", ["long", "containment"])
@pytest.mark.parametrize("seed", SEEDS)
def test_simulate_same_bytes(mode, seed, tmp_path):
    """One seed, the same FASTA files, ground truth and list."""
    fn = {"long": "simulate_long_sequences",
          "containment": "create_containment"}[mode]
    got = {}
    for side, mod in (("jax", jax_simulate), ("port", port_simulate)):
        out = tmp_path / side
        files = getattr(mod, fn)(str(out), 3, 3, 3000, seed=seed,
                                 **({"mutation": 0.02} if mode == "long"
                                    else {"min_frac": 0.3}))
        got[side] = ([os.path.relpath(f, out) for f in files],
                     {k: v.replace(str(out).encode(), b"OUT")
                      for k, v in _files(out).items()})
    assert got["port"] == got["jax"]
    assert len(got["port"][0]) == 9


def test_simulate_cli_same_bytes(tmp_path):
    _run_both(tmp_path, "simulate",
              lambda out: ["long", os.path.join(out, "sim"), "--seeds", "2",
                           "--per-cluster", "3", "--length", "2500",
                           "--mutation", "0.03", "--seed", "5"])


# ---------------------------------------------------------------------------
# evaluate and reps over a clustered simulated corpus


@pytest.fixture(scope="module")
def simulated_cluster(tmp_path_factory):
    """test_evaltools.py's corpus (4 x 4 genomes of 20 kb, seed 3),
    clustered by the port's clust-mst ``-e`` on the CPU."""
    from rabbittclust_tpu_torch.cli.clust_mst import main
    tmp = tmp_path_factory.mktemp("evalsim")
    out = str(tmp / "sim")
    port_simulate.simulate_long_sequences(out, num_seeds=4, per_cluster=4,
                                          length=20000, mutation=0.01,
                                          seed=3)
    cluster_file = str(tmp / "sim.cluster")
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        assert main(["--fast", "--device", "-l", "-i",
                     f"{out}/simulated.list", "-o", cluster_file, "-d",
                     "0.05", "-m", "1000", "-e"], device=CPU) == 0
    finally:
        os.chdir(cwd)
    return cluster_file, f"{out}/simulated.groundTruth"


def _scores(mod, cluster_file, truth_file, by_file):
    clusters = mod.parse_cluster_file(cluster_file, by_file)
    truth = mod.read_ground_truth(truth_file)
    pred, gt = mod.label_matrix(clusters, truth)
    return (clusters, truth, pred, gt, mod.nmi_score(pred, gt),
            mod.weighted_f1(pred, gt), mod.purity_report(clusters, truth),
            mod.representative_list(clusters))


def test_evaluate_simulated_corpus(simulated_cluster):
    cluster_file, truth_file = simulated_cluster
    got = _scores(port_evaluate, cluster_file, truth_file, True)
    assert got == _scores(jax_evaluate, cluster_file, truth_file, True)
    assert len(got[0]) == 4 and got[4] == 1.0 and got[5] == 1.0
    assert got[6]["purity"] == 1.0 and got[6]["coverage"] == 1.0


def _write_cluster_file(path, clusters, by_file):
    """A ``.cluster`` file in the reference's layout; each member is
    (accession, genome id)."""
    with open(path, "w") as f:
        f.write("# Clustering threshold: 0.050000\n#\n")
        for ci, members in enumerate(clusters):
            f.write(f"the cluster {ci} is: \n")
            for mi, (acc, gid) in enumerate(members):
                fn = f"/data/{acc}_ASM{gid}v1_genomic.fna.gz"
                seq = acc  # the sequence's name: -i mode reads it
                if by_file:
                    f.write(f"\t{mi:5d}\t{gid:6d}\t{25000 + gid:12d}nt\t"
                            f"{fn:>20s}\t{seq:>20s}\tOrganism x\n")
                else:
                    f.write(f"\t{mi:5d}\t{gid:6d}\t{25000 + gid:12d}nt\t"
                            f"{seq:>20s}\tOrganism x\n")
            f.write("\n")


def _scenario(tmp_path, seed, by_file=True):
    """Random clusters over species of three genera: a dominant species
    per cluster and minority members of others, a few genomes absent from
    the ground truth.  Writes the cluster file, both ground-truth forms,
    nodes.dmp, an ANI report and a genome list; returns their paths."""
    rng = random.Random(seed)
    genus_of = {900 + s: 800 + s % 3 for s in range(1, 9)}
    species = sorted(genus_of)
    clusters, labels = [], {}
    gid = 0
    for _ in range(rng.randint(6, 10)):
        dom = rng.choice(species)
        members = []
        for _ in range(rng.randint(1, 9)):
            acc = f"GCF_{gid + 1:06d}.1"
            sp = dom if rng.random() < 0.7 else rng.choice(species)
            labels[acc] = sp if rng.random() < 0.9 else None
            members.append((acc, gid))
            gid += 1
        clusters.append(members)
    # one species with no node in nodes.dmp
    for acc in list(labels)[::7]:
        if labels[acc] is not None:
            labels[acc] = 999
    cluster_file = tmp_path / "result.cluster"
    _write_cluster_file(cluster_file, clusters, by_file)
    gt2 = tmp_path / "truth.tsv"  # evaluate's <accession, taxid, name>
    gt3 = tmp_path / "ground.truth"  # taxonomy's, name = sequence name
    with open(gt2, "w") as f2, open(gt3, "w") as f3:
        f2.write("accession\ttaxid\torganismName\n")
        f3.write("assembly_accession\tspecies_taxid\torganism_name\n")
        for acc, sp in labels.items():
            if sp is None:
                continue
            f2.write(f"{acc}\t{sp}\tOrganism species{sp}\n")
            f3.write(f"{acc}\t{sp}\t{acc} Organism species{sp}\n")
    nodes = tmp_path / "nodes.dmp"
    with open(nodes, "w") as f:
        rows = [(1, 1, "no rank"), (600, 1, "order"), (700, 600, "family"),
                (701, 600, "family")]
        rows += [(g, 700 + g % 2, "genus") for g in sorted(set(
            genus_of.values()))]
        rows += [(s, g, "species") for s, g in sorted(genus_of.items())]
        for t, p, r in rows:
            f.write(f"{t}\t|\t{p}\t|\t{r}\t|\t\t|\t0\t|\n")
    ani = tmp_path / "ANI_report.txt"
    statuses = list(jax_taxonomy._MATCH_STATUSES)
    with open(ani, "w") as f:
        f.write("# genbank-accession\tspecies-taxid\tbest-match-species-"
                "taxid\tbest-match-status\texcluded-from-refseq\tqcoverage"
                "\tscoverage\n")
        for acc, sp in labels.items():
            if rng.random() < 0.15:
                continue
            sid = sp or 0
            bm = sid if rng.random() < 0.7 else rng.choice(species)
            st = "species-match" if bm == sid else rng.choice(statuses)
            efr = "na" if rng.random() < 0.8 else "partial"
            q = "na" if rng.random() < 0.1 else f"{rng.uniform(50, 100):.2f}"
            f.write(f"{acc}\t{sid}\t{bm}\t{st}\t{efr}\t{q}\t"
                    f"{rng.uniform(50, 100):.2f}\n")
    genus_tsv = tmp_path / "genus.tsv"
    species_tsv = tmp_path / "species.tsv"
    with open(genus_tsv, "w") as fg, open(species_tsv, "w") as fs:
        fg.write("assembly_accession\tgenus_id\torganism_name\n")
        fs.write("assembly_accession\tspecies_taxid\torganism_name\n")
        for acc, sp in labels.items():
            if sp is None or sp == 999:
                continue
            g = genus_of[sp]
            fg.write(f"{acc}\t{g}\tGenus{g} sp_{sp} strain\n")
            fs.write(f"{acc}\t{sp}\tGenus{genus_of[sp]} species{sp} x\n")
    fasta_list = tmp_path / "genomes.list"
    paths = []
    for k in range(4):
        p = tmp_path / f"genome{k}.fna"
        with open(p, "w") as f:
            for r in range(rng.randint(1, 3)):
                kind = rng.choice(["Escherichia coli,", "UNVERIFIED_ORG: "
                                   "Salmonella enterica", "Bacillus x"])
                if k == 0:
                    kind = "Escherichia coli,"
                f.write(f">s{k}_{r} {kind} strain {r}\nACGTACGT\n")
        paths.append(str(p))
    fasta_list.write_text("\n".join(paths) + "\n")
    return {"cluster": str(cluster_file), "truth": str(gt2),
            "truth3": str(gt3), "nodes": str(nodes), "ani": str(ani),
            "genus": str(genus_tsv), "species": str(species_tsv),
            "list": str(fasta_list)}


@pytest.mark.parametrize("by_file", [True, False], ids=["l", "i"])
@pytest.mark.parametrize("seed", SEEDS)
def test_evaluate_synthetic(seed, by_file, tmp_path):
    sc = _scenario(tmp_path, seed, by_file)
    got = _scores(port_evaluate, sc["cluster"], sc["truth"], by_file)
    assert got == _scores(jax_evaluate, sc["cluster"], sc["truth"], by_file)
    if by_file:  # accessions are found in -l mode only
        assert 0.0 < got[4] <= 1.0 and got[6]["coverage"] > 0.5
    names = ["GCF_000012.1_ASM1v1_genomic.fna.gz", "dir/x.fasta y",
             "sample.fa.gz", "GCA_123456.7", "plain"]
    assert [port_evaluate.accession_of(n) for n in names] == \
        [jax_evaluate.accession_of(n) for n in names]


@pytest.mark.parametrize("seed", SEEDS)
def test_evaluate_and_reps_cli(seed, tmp_path):
    sc = _scenario(tmp_path, seed)
    stdout, _ = _run_both(tmp_path, "evaluate",
                          lambda out: [sc["truth"], sc["cluster"], "-l"])
    assert stdout.startswith("genomes labeled:")
    _, files = _run_both(
        tmp_path / "reps", "reps",
        lambda out: [sc["cluster"], os.path.join(out, "reps.txt"), "-l"])
    assert files["reps.txt"].count(b"\n") >= 6


# ---------------------------------------------------------------------------
# newick


@pytest.fixture(scope="module")
def cli_newick(tmp_path_factory):
    """test_evaltools.py's hierarchical corpus (3 subfamilies x 3 genomes
    from one seed sequence), its ``--newick-tree`` from the port's
    clust-mst on the CPU."""
    from rabbittclust_tpu_torch.cli.clust_mst import main
    from tests.helpers import mutate, rand_seq, write_fasta
    tmp = tmp_path_factory.mktemp("evalnewick")
    rng = random.Random(21)
    seed_seq = rand_seq(rng, 30000)
    files = []
    for ci in range(3):
        base = mutate(rng, seed_seq, 0.02)
        for m in range(3):
            fp = tmp / f"g{ci}_{m}.fna"
            write_fasta(str(fp), f"genome_{ci}_{m}", f"fam{ci}",
                        mutate(rng, base, 0.001))
            files.append(str(fp))
    lst = tmp / "list.txt"
    lst.write_text("\n".join(files) + "\n")
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        assert main(["--fast", "--device", "-l", "-i", str(lst), "-o",
                     "t.cluster", "-d", "0.05", "-m", "1000",
                     "--newick-tree", "-e"], device=CPU) == 0
    finally:
        os.chdir(cwd)
    return str(tmp / "t.cluster.newick.tree")


def _random_newick(seed, n_leaves=12):
    """A random rooted tree in newick, with quoted labels holding spaces,
    quotes and commas, unlabeled and labeled internal nodes."""
    rng = random.Random(seed)
    names = [f"leaf{k}" for k in range(n_leaves)]
    for k in rng.sample(range(n_leaves), 3):
        names[k] = rng.choice(["a b", "o'brien", "x,y", "(p)"]) + str(k)

    def label(name):
        if any(c in name for c in ",():; '"):
            return "'" + name.replace("'", "''") + "'"
        return name

    nodes = [f"{label(n)}:{rng.uniform(0, 0.1):.6f}" for n in names]
    inner = 0
    while len(nodes) > 1:
        k = rng.randint(2, min(3, len(nodes)))
        picked = [nodes.pop(rng.randrange(len(nodes))) for _ in range(k)]
        lab = f"n{inner}" if rng.random() < 0.5 else ""
        inner += 1
        nodes.append(f"({','.join(picked)}){lab}:{rng.uniform(0, 0.05):.6f}")
    return nodes[0] + ";"


def _tree_results(mod, text):
    root = mod.parse_newick(text)
    terms = mod.leaves(root)
    names = [t.name for t in terms]
    dists = [mod.leaf_distance(a, b)
             for a, b in itertools.combinations(terms, 2)]
    cut = sorted(dists)[len(dists) // 3] if dists else 0.0
    buf = io.StringIO()
    mod.ascii_tree(root, out=buf)
    whole = (names, dists, mod.to_newick(root), mod.basic_stats(root),
             mod.cluster_by_threshold(root, cut), buf.getvalue())
    sub = mod.extract_subtree(root, names[::2])  # reparents the leaves
    return whole + (mod.to_newick(sub), mod.basic_stats(sub))


@pytest.mark.parametrize("seed", SEEDS)
def test_newick_synthetic(seed):
    text = _random_newick(seed)
    got = _tree_results(port_newick, text)
    assert got == _tree_results(jax_newick, text)
    assert len(got[0]) == 12


def test_newick_cli_tree(cli_newick):
    with open(cli_newick) as f:
        text = f.read()
    got = _tree_results(port_newick, text)
    assert got == _tree_results(jax_newick, text)
    assert got[3]["leaves"] == 9 and got[3]["internal_nodes"] >= 1


@pytest.mark.parametrize("source", ["synthetic", "cli"])
def test_newick_tool(source, cli_newick, tmp_path):
    """Every flag but --extract in one run, --extract in another: the same
    lines and files.  All of them in one run: the port's gives the two
    runs' lines and files, where the original fails (its --extract
    reparents the leaves of the tree the later flags read)."""
    tree = tmp_path / "in.tree"
    if source == "cli":
        with open(cli_newick) as f:
            tree.write_text(f.read())
    else:
        tree.write_text(_random_newick(7))
    names = [t.name for t in port_newick.leaves(
        port_newick.parse_newick(tree.read_text()))]

    def analyses(out):
        return [str(tree), "--stats", "--list-leaves", "4",
                "--neighbors", names[0], "--n-neighbors", "3",
                "--pairwise", names[1], names[-1],
                "--closest-pairs", "3", "--farthest-pairs", "2",
                "--distance-matrix", os.path.join(out, "dm.tsv"),
                "--ascii-tree", "--cluster-threshold", "0.05",
                "--cluster-out", os.path.join(out, "clusters.txt")]

    def extract(out):
        return ["--extract", *names[:3],
                "--extract-out", os.path.join(out, "sub.tree")]

    stdout, files = _run_both(tmp_path / "a", "newick", analyses)
    assert stdout.startswith("leaves: ")
    assert sorted(files) == ["clusters.txt", "dm.tsv"]
    _, sub = _run_both(tmp_path / "e", "newick",
                       lambda out: [str(tree), *extract(out)])
    out = tmp_path / "both"
    out.mkdir()
    rc, got, _ = _tool("port", "newick", analyses(str(out)) + extract(
        str(out)), str(out))
    assert rc == 0
    assert got.replace(str(out), "OUT") == stdout
    assert {k: v.replace(str(out).encode(), b"OUT")
            for k, v in _files(out).items()} == {**files, **sub}
    assert _tool("jax", "newick", analyses(str(out)) + extract(str(out)),
                 str(out))[0] != 0


# ---------------------------------------------------------------------------
# taxonomy


@pytest.mark.parametrize("argument", ["-l", "-i"])
@pytest.mark.parametrize("seed", SEEDS)
def test_taxonomy_functions(seed, argument, tmp_path):
    """precal_label, cal_purity, analysis_purity, check_taxonomy_status,
    load_nodes_dmp and lineage_ranks: the same returns and files."""
    sc = _scenario(tmp_path, seed, by_file=argument == "-l")
    got = {}
    for side, mod in (("jax", jax_taxonomy), ("port", port_taxonomy)):
        out = tmp_path / side
        out.mkdir()
        o = str(out / "r")
        nodes = mod.load_nodes_dmp(sc["nodes"])
        ret = [mod.precal_label(argument, sc["truth3"], sc["cluster"],
                                o + ".label"),
               mod.cal_purity(argument, sc["truth3"], sc["cluster"],
                              o + ".purity"),
               nodes, {t: mod.lineage_ranks(nodes, t)
                       for t in (1, 801, 905, 999)}]
        for level in ("species", "genus", "family"):
            ret.append(mod.analysis_purity(
                sc["nodes"], o + ".purity.accession.unpurity",
                f"{o}.{level}", level=level))
        ret.append(mod.check_taxonomy_status(sc["ani"], o + ".genus.diff",
                                             o + ".genus.diff"))
        ret.append(mod.check_taxonomy_status(sc["ani"], o + ".genus.same",
                                             o + ".genus.same"))
        ret.append(mod.resolve_cluster_labels(
            [[(901, 3), (902, 1)], [(901, 4)], [(902, 2), (903, 2)], []]))
        got[side] = (ret, _files(out))
    assert got["port"] == got["jax"]
    assert got["port"][0][3][905] == {"species": 905, "genus": 802,
                                      "family": 700, "order": 600,
                                      "no rank": 1}


def test_taxonomy_map_genome(tmp_path):
    sc = _scenario(tmp_path, 5)
    got = {}
    for side, mod in (("jax", jax_taxonomy), ("port", port_taxonomy)):
        out = str(tmp_path / f"{side}.mapType.out")
        got[side] = (mod.map_genome(sc["list"], out),
                     open(out, "rb").read())
    assert got["port"] == got["jax"]
    names = ["/d/GCF_000001.1_ASM1v1.fna", "GCA_12345.1.fa", "short",
             "/x/y/abcdefg.h"]
    assert [port_taxonomy.accession_from_filename(n) for n in names] == \
        [jax_taxonomy.accession_from_filename(n) for n in names]


@pytest.mark.parametrize("seed", SEEDS)
def test_taxonomy_tool(seed, tmp_path):
    """The five subcommands in turn, each reading the port's output of the
    step before."""
    sc = _scenario(tmp_path, seed)
    runs = [
        ("precal", lambda o: ["precal-label", "-l", sc["truth3"],
                              sc["cluster"], os.path.join(o, "x")]),
        ("purity", lambda o: ["cal-purity", "-l", sc["truth3"],
                              sc["cluster"], os.path.join(o, "p")]),
        ("analysis", lambda o: [
            "analysis-purity", sc["nodes"],
            str(tmp_path / "purity" / "port_out" / "p.accession.unpurity"),
            os.path.join(o, "a"), "--level", "genus"]),
        ("check", lambda o: [
            "check-status", sc["ani"],
            str(tmp_path / "analysis" / "port_out" / "a.diff"),
            os.path.join(o, "c")]),
        ("map", lambda o: ["map-genome", sc["list"], "-o",
                           os.path.join(o, "m.out")])]
    for sub, make in runs:
        stdout, files = _run_both(tmp_path / sub, "taxonomy", make)
        assert stdout and files


# ---------------------------------------------------------------------------
# genus_analysis (the plot aside)


@pytest.mark.parametrize("seed", SEEDS)
def test_genus_analysis_functions(seed, tmp_path):
    sc = _scenario(tmp_path, seed)
    got = {}
    for side, mod in (("jax", jax_genus), ("port", port_genus)):
        acc_cluster = mod.parse_cluster_accessions(sc["cluster"])
        acc_to_species, species_names, acc_to_org = \
            mod._read_groundtruth_tsv(sc["species"], "species_taxid", 2)
        acc_to_genus, genus_names, _ = mod._read_groundtruth_tsv(
            sc["genus"], "genus_id", 1)
        stats = mod.analyze_cluster_relationships(
            acc_cluster, acc_to_species, acc_to_org, acc_to_genus)
        co = mod.genus_cooccurrence(stats)
        got[side] = (acc_cluster, species_names, genus_names, stats,
                     dict(co), mod.classify_cooccurrence(co),
                     mod.classify_cooccurrence(co, 0.2, 0.9),
                     mod.analyze_pair_distribution(
                         dict(acc_cluster), acc_to_genus, genus_names,
                         801, 802))
    assert got["port"] == got["jax"]
    assert got["port"][0] and got["port"][3]


@pytest.mark.parametrize("seed", SEEDS)
def test_genus_analysis_tool(seed, tmp_path):
    sc = _scenario(tmp_path, seed)
    _, files = _run_both(
        tmp_path / "pair", "genus_analysis",
        lambda out: ["pair", "--cluster-file", sc["cluster"],
                     "--genus-groundtruth", sc["genus"], "--g1-id", "801",
                     "--g2-id", "802", "--g1-name", "Alpha", "--g2-name",
                     "Beta", "--output-dir", out])
    assert sorted(files) == ["alpha_beta_cluster_distribution.tsv",
                             "alpha_beta_cluster_distribution_summary.tsv"]
    _, files = _run_both(
        tmp_path / "rel", "genus_analysis",
        lambda out: ["relationships", "--cluster", sc["cluster"],
                     "--species-groundtruth", sc["species"],
                     "--genus-groundtruth", sc["genus"], "--top-k", "3",
                     "--output-dir", out])
    assert sorted(files) == ["boundary_conflicts.tsv", "cluster_summary.tsv",
                             "minority_outliers.tsv", "suspects.tsv",
                             "top_genus_pairs.tsv"]


def test_genus_analysis_usage_exit(tmp_path):
    got = {side: _tool(side, "genus_analysis", ["bogus"], str(tmp_path))
           for side in PACKAGES}
    assert got["port"] == got["jax"] and got["port"][0] == 2


# ---------------------------------------------------------------------------
# the malloc tuning at import


class _Recorder:
    """Stands in for ``ctypes.CDLL``: records each library opened and each
    ``mallopt`` call."""

    def __init__(self):
        self.calls = []

    def __call__(self, name, **kw):
        self.calls.append(("CDLL", name, tuple(sorted(kw.items()))))
        rec = self

        class _Lib:
            def mallopt(self, param, value):
                rec.calls.append(("mallopt", param, value))
                return 1
        return _Lib()


@pytest.mark.parametrize("setting", [None, "1", "0"])
def test_tune_malloc_calls_match(setting, monkeypatch):
    if setting is None:
        monkeypatch.delenv("RTC_MALLOC_REUSE", raising=False)
    else:
        monkeypatch.setenv("RTC_MALLOC_REUSE", setting)
    calls = {}
    for side, pkg in (("jax", rabbittclust_tpu),
                      ("port", rabbittclust_tpu_torch)):
        rec = _Recorder()
        monkeypatch.setattr(ctypes, "CDLL", rec)
        pkg._tune_malloc()
        calls[side] = rec.calls
    assert calls["port"] == calls["jax"]
    if setting == "0":
        assert calls["port"] == []
    else:
        assert calls["port"] == [
            ("CDLL", "libc.so.6", (("use_errno", True),)),
            ("mallopt", -3, 1 << 30), ("mallopt", -1, 1 << 30)]


def test_tune_malloc_survives_missing_libc(monkeypatch):
    def refuse(*a, **kw):
        raise OSError("no libc here")
    monkeypatch.delenv("RTC_MALLOC_REUSE", raising=False)
    monkeypatch.setattr(ctypes, "CDLL", refuse)
    assert rabbittclust_tpu_torch._tune_malloc() is None
