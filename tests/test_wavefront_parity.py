"""Differential tests: JAX wavefront engine vs NumPy reference interpreter.

The analogue of the reference's interpreter-vs-generated-code
cross-check (`--compiled no`, ref: doc/man/man1/exonerate.1:775-782,
SURVEY.md §4): both engines must agree on score AND region endpoints for
random sequence pairs across the model zoo.
"""
import numpy as np
import pytest

from exonerate_tpu.alphabet import Alphabet, AlphabetType
from exonerate_tpu.engine.region import Region
from exonerate_tpu.engine import reference, wavefront
from exonerate_tpu.model.data import AlignData, IntronArgs
from exonerate_tpu.model.affine import AffineModelType, affine_create
from exonerate_tpu.model.ungapped import ungapped_create
from exonerate_tpu.model.match import MatchType
from exonerate_tpu.model.est2genome import est2genome_create
from exonerate_tpu.model.ner import ner_create
from exonerate_tpu.model.protein2dna import protein2dna_create
from exonerate_tpu.model.protein2genome import protein2genome_create
from exonerate_tpu.model.coding2coding import coding2coding_create
from exonerate_tpu.seqio import Sequence

DNA = Alphabet(AlphabetType.DNA)
PROTEIN = Alphabet(AlphabetType.PROTEIN)
rng = np.random.default_rng(1234)


def rand_dna(n):
    return Sequence("s", None, "".join(rng.choice(list("ACGTN"), n)), DNA)


def rand_protein(n):
    return Sequence("s", None,
                    "".join(rng.choice(list("ARNDCQEGHILKMFPSTWYV"), n)),
                    PROTEIN)


def check(model, q, t, translate_both=False, intron=None):
    data = AlignData(q, t, translate_both)
    if intron:
        data.intron = intron
    region = Region(0, 0, len(q), len(t))
    wf = wavefront.find_region(model, region, data)
    rf = reference.find_region(model, region, data)
    assert wf.score == rf.score, (wf, rf)
    assert (wf.query_end, wf.target_end) == (rf.query_end, rf.target_end)
    assert (wf.query_start, wf.target_start) == \
        (rf.query_start, rf.target_start)


@pytest.mark.parametrize("atype", list(AffineModelType))
def test_affine_random(atype):
    model = affine_create(atype, AlphabetType.DNA, AlphabetType.DNA)
    for _ in range(3):
        check(model, rand_dna(30), rand_dna(45))


def test_ungapped_random():
    model = ungapped_create(MatchType.DNA2DNA)
    for _ in range(3):
        check(model, rand_dna(40), rand_dna(40))


def test_est2genome_random():
    # short intron window so random introns are actually possible
    intron = IntronArgs(min_intron=5, max_intron=100)
    model = est2genome_create(intron)
    for _ in range(2):
        check(model, rand_dna(30), rand_dna(80), intron=intron)


def test_ner_random():
    model = ner_create(AlphabetType.DNA, AlphabetType.DNA)
    check(model, rand_dna(40), rand_dna(60))


def test_protein2dna_random():
    model = protein2dna_create()
    check(model, rand_protein(15), rand_dna(60))


def test_protein2genome_random():
    intron = IntronArgs(min_intron=5, max_intron=100)
    model = protein2genome_create(intron_args=intron)
    check(model, rand_protein(12), rand_dna(70), intron=intron)


def test_coding2coding_random():
    model = coding2coding_create()
    check(model, rand_dna(30), rand_dna(45), translate_both=True)


def test_subopt_blocking_parity():
    """Waterman-Eggert iterations must agree between engines (exercises
    the bit-packed blocked plane)."""
    from exonerate_tpu.engine.subopt import SubOpt
    from exonerate_tpu.align.alignment import Alignment
    model = affine_create(AffineModelType.LOCAL, AlphabetType.DNA,
                          AlphabetType.DNA)
    q, t = rand_dna(40), rand_dna(60)
    data = AlignData(q, t)
    region = Region(0, 0, len(q), len(t))
    so_w, so_r = SubOpt(), SubOpt()
    for _ in range(3):
        wf = wavefront.find_path(model, region, data, subopt=so_w)
        rf = reference.find_path(model, region, data, subopt=so_r)
        assert wf.score == rf.score
        assert [x.id for x in wf.path] == [x.id for x in rf.path]
        al = Alignment.from_path(
            model, Region(wf.query_start, wf.target_start,
                          wf.query_end - wf.query_start,
                          wf.target_end - wf.target_start),
            wf.score, wf.path)
        so_w.add_alignment(al)
        so_r.add_alignment(al)


def test_checkpointed_path_parity():
    """--dpmemory-bounded traceback must reproduce the full-cube path."""
    from exonerate_tpu.model.est2genome import est2genome_create
    intron = IntronArgs(min_intron=5, max_intron=100)
    model = est2genome_create(intron)
    q, t = rand_dna(40), rand_dna(120)
    data = AlignData(q, t)
    data.intron = intron
    region = Region(0, 0, len(q), len(t))
    full = wavefront.find_path(model, region, data)
    ck = wavefront.find_path_checkpointed(model, region, data,
                                          budget_bytes=32 * 1024)
    assert full.score == ck.score
    assert [x.id for x in full.path] == [x.id for x in ck.path]
    assert (full.query_start, full.target_start) == \
        (ck.query_start, ck.target_start)
