"""XLA wavefront engine vs the NumPy reference interpreter, per model
family, in region and path mode.

The exhaustive device route (engine/optimal.py on an accelerator) runs
engine/wavefront.py: the region scan finds the alignment's box, the
path mode (traceback planes + host walk-back) recovers its transitions.
Both must agree exactly with the oracle interpreter (int32 scores, the
reference's first-max tie-breaking) on pairs with real signal: codon
models (advances 3 and 6), NER spans, affine gaps, and split-codon
introns in both phases.
"""
import pytest

from exonerate_tpu.engine import reference, wavefront
from exonerate_tpu.engine.region import Region
from exonerate_tpu.model.affine import AffineModelType, affine_create
from exonerate_tpu.model.data import AlignData
from exonerate_tpu.model.registry import ModelType, get_model
from exonerate_tpu.seqio import Sequence

from benchmarks import fixtures

PROT = "MADQLTEEQIAEFKEAFSLFDKDGDGTITTKELGTVMRSL"
EXON1 = "ATGGCTGACCAGCTGACTGAGCAGATTGCAGAGTTCAA"
EXON2 = "GGGAGGCCTTCTCCCTCTTTGACAAGGATGGAGATGGCACTATTACCACC"


def _calm_dna(n):
    return Sequence("d", None, fixtures.calm_cdna()[:n])


def _family(name):
    if name == "affine":
        a = Sequence("a", None, "MKVLAAGICAGWLLWKKMKVL" * 3)
        b = Sequence("b", None, "MKVLGAGICAWWLLAKKMK" * 3)
        from exonerate_tpu.alphabet import AlphabetType
        return (affine_create(AffineModelType.LOCAL, AlphabetType.PROTEIN,
                              AlphabetType.PROTEIN), a, b)
    if name.startswith("split"):
        e1, e2 = EXON1, EXON2
        if name == "split2":
            e1, e2 = e1 + "G", e2[1:]
        q = Sequence("p", None, "MADQLTEQIAEFKEAFSLFDKDGDGTITT")
        t = Sequence("g", None, e1 + "GT" + "N" * 43 + "AG" + e2)
        mt = ModelType.PROTEIN2GENOME
    elif name == "NER":
        q = Sequence("n1", None, PROT[:20] + "WWHHKKPP" + PROT[20:])
        t = Sequence("n2", None, PROT[:20] + "GGSS" + PROT[20:])
        mt = ModelType.NER
    elif name.startswith("PROTEIN"):
        q, t = Sequence("p", None, PROT), _calm_dna(260)
        mt = ModelType[name]
    else:
        q = t = _calm_dna(180)
        mt = ModelType[name]
    return get_model(mt, q.alphabet.type, t.alphabet.type), q, t


FAMILIES = ["PROTEIN2DNA", "PROTEIN2GENOME", "CODING2CODING", "NER",
            "affine", "split1", "split2"]


@pytest.mark.parametrize("mode", ["region", "path"])
@pytest.mark.parametrize("family", FAMILIES)
def test_wavefront_matches_oracle(family, mode):
    model, q, t = _family(family)
    data = AlignData(q, t)
    region = Region(0, 0, len(q), len(t))
    key = lambda r: (r.score, r.query_start, r.target_start,
                     r.query_end, r.target_end)
    if mode == "region":
        got = wavefront.find_region(model, region, data)
        want = reference.find_region(model, region, data)
        assert key(got) == key(want)
    else:
        got = wavefront.find_path(model, region, data)
        want = reference.viterbi(model, region, data, "path")
        assert key(got) == key(want)
        assert [x.name for x in got.path] == [x.name for x in want.path]
    assert got.score > 0
    if family.startswith("split"):
        assert got.score > 100   # the intron path, not a local fragment
