"""Differential tests: native (C++) SDP scheduler vs the Python oracle.

The Python _Pass in engine/sdp.py is the behavioural specification
(itself byte-golden against reference exonerate); the native scheduler
must produce identical alignments for every supported model family.
"""
import io
import os

import numpy as np
import pytest

from exonerate_tpu.engine import sdp_native

from benchmarks.fixtures import corpus_dir

DATA = corpus_dir()

pytestmark = pytest.mark.skipif(sdp_native.get_lib() is None,
                                reason="native toolchain unavailable")

CDNA = DATA + "/cdna"
PROT = DATA + "/protein"
HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "golden", "data")


def _run_cli(args):
    from exonerate_tpu.cli.exonerate import main
    buf = io.StringIO()
    rc = main(list(args), out=buf)
    assert not rc
    return buf.getvalue()


def _both(args):
    os.environ["EXONERATE_TPU_SDP"] = "python"
    try:
        py = _run_cli(args)
    finally:
        os.environ.pop("EXONERATE_TPU_SDP", None)
    nat = _run_cli(args)
    return py, nat


@pytest.fixture(scope="module", autouse=True)
def fixtures_present():
    import sys
    sys.path.insert(0, os.path.join(HERE, "golden"))
    import cases
    cases.make_fixtures()


NOAL = ["--showalignment", "no", "--showvulgar", "yes"]


@pytest.mark.parametrize("name,args", [
    ("affine_local", ["-m", "affine:local", f"{FIX}/cdna_mut.fa",
                      f"{CDNA}/calm.human.dna.fasta"]),
    ("est2genome", ["-m", "est2genome", f"{FIX}/cdna_mut.fa",
                    f"{FIX}/genome.fa"]),
    ("est2genome_bestn", ["-m", "est2genome", "--bestn", "3",
                          f"{CDNA}/calm.human.dna.fasta",
                          f"{FIX}/genome.fa"]),
    ("protein2genome", ["-m", "protein2genome",
                        f"{PROT}/calm.human.protein.fasta",
                        f"{FIX}/genome.fa"]),
    ("coding2genome", ["-m", "coding2genome", f"{FIX}/cdna_mut.fa",
                       f"{FIX}/genome.fa"]),
    pytest.param("cdna2genome", ["-m", "cdna2genome", "--annotation",
                 f"{FIX}/annot.txt", f"{FIX}/cdna_mut.fa",
                 f"{FIX}/genome.fa"], marks=pytest.mark.slow),
    pytest.param("genome2genome", ["-m", "genome2genome",
                 f"{FIX}/cdna_mut.fa", f"{FIX}/genome.fa"],
                 marks=pytest.mark.slow),
    ("ner", ["-m", "ner", f"{FIX}/ner1.fa", f"{FIX}/ner2.fa"]),
])
def test_native_matches_python(name, args):
    py, nat = _both(args + NOAL)
    assert py == nat, f"{name}: native SDP diverges from oracle"


@pytest.mark.slow
def test_wordhood_native_matches_python():
    from exonerate_tpu import native
    rng = np.random.default_rng(7)
    m = rng.integers(-6, 12, (22, 22))
    m = (m + m.T) // 2
    for _ in range(25):
        word = [int(x) for x in rng.integers(0, 22, 5)]
        thr = int(sum(m[c, c] for c in word)) - 20
        nat = native.wordhood_neighbours(m, word, thr)
        assert nat is not None
        # reference python DFS
        col_max = m.max(axis=1)
        suffix = [0] * 6
        for i in range(4, -1, -1):
            suffix[i] = suffix[i + 1] + int(col_max[word[i]])
        out = []

        def dfs(pos, score, acc):
            if pos == 5:
                if score >= thr:
                    out.append(acc)
                return
            row = m[word[pos]]
            bound = thr - score - suffix[pos + 1]
            for c in range(22):
                s0 = int(row[c])
                if s0 >= bound:
                    dfs(pos + 1, score + s0, acc * 22 + c)

        dfs(0, 0, 0)
        assert nat == out


@pytest.mark.parametrize("seed", [11, 22, 33])
def test_native_fuzz_random_pairs(seed, tmp_path):
    """Randomized pairs (mutations, insertions, shuffled blocks) must
    give identical output from the native scheduler and the oracle."""
    rng = np.random.default_rng(seed)
    base = "".join(rng.choice(list("ACGT"), 3000))
    q = list(base[200:800])
    # mutate, delete a block, insert noise
    for _ in range(40):
        q[int(rng.integers(0, len(q)))] = str(rng.choice(list("ACGT")))
    del q[100:130]
    q[300:300] = list("".join(rng.choice(list("ACGT"), 25)))
    qf = tmp_path / "q.fa"
    tf = tmp_path / "t.fa"
    qf.write_text(">q\n" + "".join(q) + "\n")
    tf.write_text(">t\n" + base + "\n")
    for model in ("affine:local", "est2genome"):
        args = ["-m", model, str(qf), str(tf)] + NOAL
        py, nat = _both(args)
        assert py == nat, f"seed {seed} model {model}"
