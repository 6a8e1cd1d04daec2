"""Byte-golden parity with the device SDP tier forced.

EXONERATE_TPU_SDP=device routes eligible heuristic comparisons through
HybridSDPPair (engine/sdp_hybrid.py): band planning + the device band
scan + lazy host locus resolution with score cross-checks.  On the CPU
test backend the scan runs as the same XLA lax.scan expression
(engine/sdp_device.py) the GPU runs by default.  Output bytes must
match the reference goldens exactly.
"""
from __future__ import annotations

import io
import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "golden"))
import cases  # noqa: E402

# strategy-diverse subset of heuristic cases whose models are
# device-eligible (boundary and non-boundary, spans, annotation,
# geneseed, refinement, subopt, bestn ties, splice forcing)
DEVICE_CASES = [
    "est2genome_genomic",
    "est2genome_bestn",
    "coding2genome",
    "cdna2genome_annot",
    "annotation_minus",
    "protein2genome_gff",
    "affine_local_dna_cross",
    "geneseed",
    "refine_region",
    "subopt_no",
    "forcegtag",
    "intron_penalty_opts",
    "bestn_ties",
    "querygff",
    "gapped_no_extension",
]

# fast tier keeps a representative trio (boundary est2genome, a
# non-boundary affine, a bestn/ungapped case); the rest are tiered slow
# so `pytest -m "not slow"` stays under its budget
_SLOW = {"protein2genome_gff", "cdna2genome_annot", "annotation_minus",
         "coding2genome", "est2genome_bestn", "refine_region",
         "geneseed", "forcegtag", "subopt_no", "querygff",
         "intron_penalty_opts"}


def _params():
    by_name = {name: (prog, argv) for name, prog, argv in cases.CASES}
    out = []
    for name in DEVICE_CASES:
        prog, argv = by_name[name]
        path = os.path.join(cases.OUTDIR, name + ".txt")
        if os.path.exists(path):
            marks = [pytest.mark.slow] if name in _SLOW else []
            out.append(pytest.param(name, prog, argv,
                                    id=name, marks=marks))
    return out


@pytest.fixture(scope="module", autouse=True)
def fixtures_present():
    cases.make_fixtures()


@pytest.fixture(autouse=True)
def force_device(monkeypatch):
    monkeypatch.setenv("EXONERATE_TPU_SDP", "device")


@pytest.mark.parametrize("name,prog,argv", _params())
def test_golden_device(name, prog, argv):
    from exonerate_tpu.cli.exonerate import main
    buf = io.StringIO()
    rc = main(list(argv), out=buf)
    assert not rc, f"{name}: exit code {rc}"
    got = cases.normalize(buf.getvalue())
    with open(os.path.join(cases.OUTDIR, name + ".txt")) as f:
        want = f.read()
    if got != want:
        import difflib
        diff = "\n".join(list(difflib.unified_diff(
            want.splitlines(), got.splitlines(),
            "reference", "exonerate_tpu[device]", lineterm=""))[:60])
        raise AssertionError(f"{name} device-tier mismatch:\n{diff}")
