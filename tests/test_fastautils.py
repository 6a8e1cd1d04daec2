"""Tests for the fasta* utilities, following the reference's shell tests
(ref: test/util/*.test.sh)."""
import io
import os

import pytest

from exonerate_tpu.cli.fastautils import main

from benchmarks.fixtures import corpus_dir

DATA = corpus_dir()

PROTEIN = DATA + "/protein/calm.human.protein.fasta"
CDNA = DATA + "/cdna/calm.human.dna.fasta"
PROTEIN_DIR = DATA + "/protein"


def run(args):
    out = io.StringIO()
    assert main(args, out=out) == 0
    return out.getvalue()


def test_fastalength():
    # ref: test/util/fastalength.test.sh (149 CALM_HUMAN)
    text = run(["fastalength", PROTEIN])
    assert text.splitlines()[0] == "149 CALM_HUMAN"


def test_fastasubseq():
    # ref: test/util/fastasubseq.test.sh (AEFKEAFSLF)
    text = run(["fastasubseq", PROTEIN, "--start", "10",
                "--length", "10"])
    assert text.splitlines()[-1] == "AEFKEAFSLF"


def test_fastatranslate_cds():
    # ref: test/util/fastatranslate.test.sh: CDS 103..549 translates to
    # the calm protein (without terminal stop)
    sub = run(["fastasubseq", CDNA, "--start", "103", "--length", "447"])
    import tempfile
    with tempfile.NamedTemporaryFile("w", suffix=".fa",
                                     delete=False) as fh:
        fh.write(sub)
        path = fh.name
    text = run(["fastatranslate", path, "--frame", "1"])
    pep = "".join(text.splitlines()[1:])
    from exonerate_tpu.seqio import iter_fasta
    prot = str(list(iter_fasta(PROTEIN))[0])
    assert pep == prot
    os.unlink(path)


def test_fastasort_len(tmp_path):
    import glob
    merged = tmp_path / "merged.fa"
    with open(merged, "w") as out:
        for f in sorted(glob.glob(PROTEIN_DIR + "/*.fasta")):
            out.write(open(f).read())
    text = run(["fastasort", str(merged), "--key", "len"])
    lengths = []
    for line in text.splitlines():
        if line.startswith(">"):
            lengths.append(0)
        else:
            lengths[-1] += len(line)
    assert lengths == sorted(lengths)


def test_fastarevcomp_roundtrip(tmp_path):
    text = run(["fastarevcomp", CDNA])
    p = tmp_path / "rc.fa"
    p.write_text(text)
    text2 = run(["fastarevcomp", str(p)])
    orig = run(["fastareformat", CDNA])
    body = lambda t: "".join(ln for ln in t.splitlines()
                             if not ln.startswith(">"))
    assert body(text2) == body(orig)


def test_fastanrdb(tmp_path):
    p = tmp_path / "dup.fa"
    p.write_text(">a\nACGT\n>b\nACGT\n>c\nTTTT\n")
    text = run(["fastanrdb", str(p)])
    # byte layout per the reference: merged ids each prefixed with a
    # space (double space after the lead id), singletons keep a trailing
    # space, output sorted by GCG checksum (ref: fastanrdb.c:95-145)
    lines = text.splitlines()
    assert ">a  b" in lines and ">c " in lines
    assert text.index("ACGT") > text.index(">a  b")


def test_fastacomposition():
    text = run(["fastacomposition", PROTEIN])
    assert text.startswith(PROTEIN)
    assert " A " in text or " A" in text


def test_fastavalidcds(tmp_path):
    p = tmp_path / "cds.fa"
    p.write_text(">good\nATGAAATAA\n>bad\nATGAAA\n")
    text = run(["fastavalidcds", str(p)])
    assert ">good" in text and ">bad" not in text


def test_fastaannotatecdna():
    text = run(["fastaannotatecdna", CDNA, PROTEIN])
    # CDS at 104 (1-based), 147 aa = 441 bases + stop; forward strand
    # (the golden suite asserts the byte-exact reference line)
    assert text.splitlines()[0] == "annotation: EMBL:J04046 + 104 447"


def test_esd_esi_roundtrip(tmp_path):
    esd = str(tmp_path / "db.esd.npz")
    esi = str(tmp_path / "db.esi.npz")
    run(["fasta2esd", CDNA, esd])
    run(["esd2esi", esd, esi])
    from exonerate_tpu.db.dataset import Dataset
    from exonerate_tpu.db.index import Index
    from exonerate_tpu.seqio import iter_fasta
    ds = Dataset(esd)
    assert len(ds) == 1
    orig = list(iter_fasta(CDNA))[0]
    got = ds.get_sequence(0)
    assert got.id == orig.id
    assert got.data.tobytes() == orig.data.tobytes()
    ix = Index(esi, ds)
    seeds = ix.get_hsp_seeds(orig)
    assert 0 in seeds
    # self words: every position seeds at least itself
    pairs = set(seeds[0])
    assert (0, 0) in pairs and (100, 100) in pairs
