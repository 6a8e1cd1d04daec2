"""Differential tests: device SDP band scan vs the Python oracle.

The device scan (engine/sdp_device.py) must reproduce the sparse SDP
scheduler's scores exactly: per-locus best end score == max over the
locus's seeds of the oracle SDPPair's max_end.score, and (non-boundary
models) per-seed start scores == the oracle's max_start.score.
"""
from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np
import pytest

from exonerate_tpu.alphabet import AlphabetType
from exonerate_tpu.model.registry import ModelType, get_model
from exonerate_tpu.model.data import AlignData
from exonerate_tpu.seqio import Sequence
from exonerate_tpu.engine.sdp import SDPPair, SdpArgs
from exonerate_tpu.engine import sdp_device, sdp_bands

rng = np.random.default_rng(7)

DD = (AlphabetType.DNA, AlphabetType.DNA)
PD = (AlphabetType.PROTEIN, AlphabetType.DNA)


def _mutate(s, n):
    s = list(s)
    for _ in range(n):
        s[rng.integers(0, len(s))] = "ACGT"[rng.integers(0, 4)]
    return "".join(s)


def _run(mtname, q, t, hsp_list, qadv=1, tadv=1, margin=64, qt=DD):
    os.environ["EXONERATE_TPU_SDP"] = "python"
    try:
        model = get_model(ModelType[mtname], *qt)
        assert sdp_device.supported(model), mtname
        qs = Sequence("q", None, q)
        ts = Sequence("t", None, t)
        data = AlignData(qs, ts)
        hl = [SimpleNamespace(query_start=a, target_start=b, length=c,
                              score=d, cobs=c // 2)
              for (a, b, c, d) in hsp_list]
        hs = SimpleNamespace(qadv=qadv, tadv=tadv, hsps=hl)
        comp = SimpleNamespace(query=qs, target=ts,
                               hspsets=lambda: [hs])
        pair = SDPPair(model, comp, data, None, SdpArgs())
        pair._find_starts()
        pair._find_ends()
        extents = [(s.hsp.target_start,
                    s.hsp.target_start + s.hsp.length * tadv)
                   for s in pair.seeds]
        sw = max((sp.max_target for sp in model.spans), default=0)
        plan = sdp_bands.plan_bands(extents, len(q), len(t),
                                    margin=margin,
                                    span_window=sw + 2 * margin)
        inputs, kinds = sdp_device.prepare_inputs(model, pair, plan)
        inputs.update(sdp_device.prepare_seeds(pair, plan,
                                               len(pair.seeds)))
        fn = sdp_device.get_fn(model, pair.region.query_length, plan.W,
                               kinds, pair.use_boundary,
                               len(pair.seeds), len(plan.loci) + 1,
                               pair.args.dropoff)
        out = {k: np.asarray(v) for k, v in fn(inputs).items()}
        assert not out["xband"], "cross-locus thaw must be impossible"
        exp = np.full(len(plan.loci), sdp_device.NEG, np.int64)
        for lx, lc in enumerate(plan.loci):
            for s in pair.seeds[lc.seed_lo:lc.seed_hi]:
                exp[lx] = max(exp[lx], s.max_end.score)
        got = out["band_end"][:len(plan.loci)]
        if out["live"]:
            # extension escaped the band margin: the production path
            # falls back to the host engine; the device must still
            # never OVERcount
            assert np.all(got <= exp), (got, exp)
        else:
            assert np.array_equal(got, exp), (got, exp)
            if not pair.use_boundary:
                exp_start = np.array([s.max_start.score
                                      for s in pair.seeds])
                got_start = out["start_scores"][:len(pair.seeds)]
                assert np.array_equal(got_start, exp_start), \
                    (got_start, exp_start)
        return out
    finally:
        os.environ.pop("EXONERATE_TPU_SDP", None)


def test_affine_local_single_band():
    base = "".join(rng.choice(list("ACGT"), 400))
    q = base[:200]
    t = _mutate(base[50:350], 20)
    _run("AFFINE_LOCAL", q, t, [(60, 10, 80, 300)])


def test_affine_local_two_bands():
    base = "".join(rng.choice(list("ACGT"), 400))
    q = base[:200]
    t = ("".join(rng.choice(list("ACGT"), 500)) + q[:120]
         + "".join(rng.choice(list("ACGT"), 800))
         + _mutate(q[60:200], 10)
         + "".join(rng.choice(list("ACGT"), 400)))
    _run("AFFINE_LOCAL", q, t,
         [(5, 505, 100, 350), (70, 1430, 110, 320)], margin=100)


def _gene():
    ex1 = "".join(rng.choice(list("ACGT"), 150))
    ex2 = "".join(rng.choice(list("ACGT"), 150))
    intr = "GT" + "".join(rng.choice(list("ACGT"), 96)) + "AG"
    return ex1, ex2, intr


def test_est2genome_spliced():
    ex1, ex2, intr = _gene()
    genome = ("".join(rng.choice(list("acgt"), 200)) + ex1 + intr + ex2
              + "".join(rng.choice(list("acgt"), 200))).upper()
    cdna = _mutate(ex1 + ex2, 8)
    _run("EST2GENOME", cdna, genome,
         [(10, 210, 120, 400), (160, 458, 130, 430)], margin=96)


def test_est2genome_cross_segment_intron():
    """Exons in separate segments of one locus: the span carry must
    teleport across the removed gap with absolute window checks."""
    ex1, ex2, _ = _gene()
    genome = (("".join(rng.choice(list("acgt"), 300)) + ex1
               + "".join(rng.choice(list("acgt"), 3000)) + ex2
               + "".join(rng.choice(list("acgt"), 300)))).upper()
    cdna = _mutate(ex1 + ex2, 8)
    _run("EST2GENOME", cdna, genome,
         [(10, 310, 120, 400), (160, 3460, 130, 430)], margin=128)


def test_protein2genome_split_codon():
    from exonerate_tpu.translate import default_code
    ex1, ex2, intr = _gene()
    code = default_code()
    pep = code.translate(
        np.frombuffer((ex1 + ex2).encode(), np.uint8), 1)
    pep = pep.tobytes().decode()[:90]
    genome = ("".join(rng.choice(list("acgt"), 120)) + ex1 + intr + ex2
              + "".join(rng.choice(list("acgt"), 120))).upper()
    _run("PROTEIN2GENOME", pep, genome,
         [(2, 126, 40, 200), (55, 430, 28, 160)],
         qadv=1, tadv=3, margin=80, qt=PD)


def test_coding2genome():
    ex1, ex2, intr = _gene()
    genome = ("".join(rng.choice(list("acgt"), 120)) + ex1 + intr + ex2
              + "".join(rng.choice(list("acgt"), 120))).upper()
    cdna = _mutate(ex1 + ex2, 8)[:200]
    _run("CODING2GENOME", cdna, genome, [(5, 125, 60, 260)],
         qadv=3, tadv=3, margin=80)


@pytest.mark.parametrize("trial", range(4))
def test_est2genome_fuzz(trial):
    r = np.random.default_rng(100 + trial)
    g = "".join(r.choice(list("ACGT"), 1500))
    qq = _mutate(g[200:400] + g[700:900], 25)
    hl = []
    for _ in range(int(r.integers(1, 4))):
        qs0 = int(r.integers(0, len(qq) - 40))
        ts0 = int(r.integers(0, 1500 - 40))
        hl.append((qs0, ts0, int(r.integers(15, 40)),
                   int(r.integers(80, 300))))
    _run("EST2GENOME", qq, g, hl, margin=int(r.integers(48, 200)))


def test_protein2dna_multi_portal_boundary():
    """protein2dna: no spans/shadows but multiple portals force the
    boundary protocol; 1:3 advances exercise the contiguity vetoes."""
    from exonerate_tpu.translate import default_code
    r = np.random.default_rng(21)
    dna = "".join(r.choice(list("ACGT"), 600))
    code = default_code()
    pep = code.translate(
        np.frombuffer(dna[90:390].encode(), np.uint8), 1)
    pep = pep.tobytes().decode().replace("*", "S")
    _run("PROTEIN2DNA", pep, dna, [(5, 105, 30, 180)],
         qadv=1, tadv=3, margin=90, qt=PD)


def test_coding2coding_frameshifts():
    r = np.random.default_rng(22)
    base = "".join(r.choice(list("ACGT"), 500))
    q = base[:300]
    t = _mutate(base[40:460], 20)
    _run("CODING2CODING", q, t, [(30, 5, 45, 220)],
         qadv=3, tadv=3, margin=120)


PP = (AlphabetType.PROTEIN, AlphabetType.PROTEIN)

_AAS = list("ACDEFGHIKLMNPQRSTVWY")


def test_ner_joint_span():
    """ner: a JOINT span (max_query = max_target = 50000) with a silent
    exit from the span state — exercises the lane-shifted curr register
    and the pre-silent span phase (ref: scheduler.c:567-645)."""
    r = np.random.default_rng(31)
    blockA = "".join(r.choice(_AAS, 60))
    blockB = "".join(r.choice(_AAS, 60))
    link1 = "".join(r.choice(_AAS, 25))
    link2 = "".join(r.choice(_AAS, 40))
    q = blockA + link1 + blockB
    t = blockA + link2 + blockB
    _run("NER", q, t, [(5, 5, 40, 220), (95, 110, 40, 220)],
         margin=64, qt=PP)


def test_ner_single_block():
    r = np.random.default_rng(32)
    base = "".join(r.choice(_AAS, 120))
    q = base
    tl = list(base)
    for _ in range(15):
        tl[int(r.integers(0, len(tl)))] = str(r.choice(_AAS))
    _run("NER", q, "".join(tl), [(10, 10, 60, 260)], margin=64, qt=PP)


def test_genome2genome_spliced():
    """genome2genome: target, query-only (reference no-op) and joint
    intron spans in one model."""
    r = np.random.default_rng(33)
    ex1 = "".join(r.choice(list("ACGT"), 120))
    ex2 = "".join(r.choice(list("ACGT"), 120))
    intr = "GT" + "".join(r.choice(list("ACGT"), 76)) + "AG"
    genome = ("".join(r.choice(list("ACGT"), 150)) + ex1 + intr + ex2
              + "".join(r.choice(list("ACGT"), 150)))
    cdna = list(ex1 + ex2)
    for _ in range(10):
        cdna[int(r.integers(0, len(cdna)))] = str(
            r.choice(list("ACGT")))
    _run("GENOME2GENOME", "".join(cdna), genome,
         [(10, 160, 80, 300), (130, 360, 80, 300)], margin=96)


_CODON = {"A": "GCT", "C": "TGT", "D": "GAT", "E": "GAA", "F": "TTT",
          "G": "GGT", "H": "CAT", "I": "ATT", "K": "AAA", "L": "CTT",
          "M": "ATG", "N": "AAT", "P": "CCT", "Q": "CAA", "R": "CGT",
          "S": "TCT", "T": "ACT", "V": "GTT", "W": "TGG", "Y": "TAT"}


def _band_case(name):
    """(model, query, target, hsps, kwargs) of the band-scan cases the
    removed fused band kernel was checked on."""
    import zlib
    r = np.random.default_rng(zlib.crc32(name.encode()))
    dna = lambda n: "".join("ACGT"[k] for k in r.integers(0, 4, n))

    def mutate(s, n):
        s = list(s)
        for _ in range(n):
            s[r.integers(0, len(s))] = "ACGT"[r.integers(0, 4)]
        return "".join(s)
    aas = list("ACDEFGHIKLMNPQRSTVWY")
    if name == "est2genome_single_exon":
        cdna = dna(120)
        return ("EST2GENOME", mutate(cdna, 6), dna(200) + cdna + dna(200),
                [(30, 230, 40, 60)], {})
    if name == "est2genome_two_exons":
        ex1, ex2 = dna(90), dna(90)
        t = dna(100) + ex1 + "GT" + dna(96) + "AG" + ex2 + dna(100)
        return ("EST2GENOME", mutate(ex1 + ex2, 4), t,
                [(10, 110, 50, 70), (100, 300, 50, 70)], {})
    if name == "est2genome_two_distant_loci":
        cdna = dna(100)
        t = dna(150) + cdna + dna(5000) + mutate(cdna, 3) + dna(150)
        return ("EST2GENOME", mutate(cdna, 5), t,
                [(20, 170, 40, 55), (20, 5270, 40, 55)], {})
    if name == "est2genome_seed_layers_same_column":
        cdna = dna(140)
        return ("EST2GENOME", mutate(cdna, 4), dna(100) + cdna + dna(100),
                [(10, 110, 40, 50), (60, 90, 40, 50)], {})
    if name == "protein2genome_boundary":
        prot = "".join(r.choice(aas, 50))
        t = dna(60) + "".join(_CODON[c] for c in prot) + dna(60)
        return ("PROTEIN2GENOME", prot, t, [(5, 75, 30, 80)],
                dict(qadv=1, tadv=3, qt=PD))
    if name == "ner_joint_span":
        a, b = "".join(r.choice(aas, 60)), "".join(r.choice(aas, 60))
        q = a + "".join(r.choice(aas, 25)) + b
        t = a + "".join(r.choice(aas, 40)) + b
        return ("NER", q, t, [(5, 5, 40, 220), (95, 110, 40, 220)],
                dict(qt=(AlphabetType.PROTEIN, AlphabetType.PROTEIN)))
    ex = dna(120)
    return ("GENOME2GENOME", ex, dna(100) + ex + dna(100),
            [(10, 110, 60, 200)], {})


@pytest.mark.parametrize("name", [
    "est2genome_single_exon", "est2genome_two_exons",
    "est2genome_two_distant_loci", "est2genome_seed_layers_same_column",
    "protein2genome_boundary", "ner_joint_span", "genome2genome"])
def test_band_scan_pairs(name):
    """Per-locus end scores (and, for non-boundary models, per-seed
    start scores) equal the oracle's; a band flagged live never
    overcounts (see _run)."""
    mtname, q, t, hsps, kw = _band_case(name)
    out = _run(mtname, q, t, hsps, **kw)
    assert not out["xband"]
