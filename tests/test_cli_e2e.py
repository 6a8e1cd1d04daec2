"""End-to-end CLI tests against the reference integration cribs
(ref: test/exonerate/exonerate.simple.test.sh)."""
import io

import pytest

from exonerate_tpu.cli.exonerate import main

from benchmarks.fixtures import corpus_dir

DATA = corpus_dir()

CALM = DATA + "/cdna/calm.human.dna.fasta"
CDNA_DIR = DATA + "/cdna"
PROTEIN_DIR = DATA + "/protein"


def run_cli(argv):
    out = io.StringIO()
    main(argv, out=out)
    return out.getvalue()


def test_calm_selfalign_vulgar_10875():
    # ref: test/exonerate/exonerate.simple.test.sh:24-31
    text = run_cli(["--bestn", "1", "--showvulgar", "yes",
                    "--showalignment", "no", CALM, CALM])
    vulgar = [ln for ln in text.splitlines() if ln.startswith("vulgar:")]
    assert vulgar, text
    fields = vulgar[0].split()
    assert fields[9] == "10875"
    assert vulgar[0] == ("vulgar: EMBL:J04046 0 2175 + EMBL:J04046 0 2175"
                        " + 10875 M 2175 2175")


def test_calm_selfalign_cigar_and_sugar():
    text = run_cli(["--bestn", "1", "--showvulgar", "no",
                    "--showalignment", "no", "--showcigar", "yes",
                    "--showsugar", "yes", CALM, CALM])
    # double space after the score: the reference's zero-move first
    # cigar group flips the separator (ref: alignment.c:1656-1681)
    assert ("cigar: EMBL:J04046 0 2175 + EMBL:J04046 0 2175 + 10875  M 2175"
            in text)
    assert ("sugar: EMBL:J04046 0 2175 + EMBL:J04046 0 2175 + 10875"
            in text)


def test_revcomp_strand_reported():
    # self-alignment also yields revcomp-strand results below bestn=1;
    # raising bestn must show at least one minus-strand alignment of the
    # palindromic word hits (threshold filters most).
    text = run_cli(["--showvulgar", "yes", "--showalignment", "no",
                    "--score", "200", CALM, CALM])
    lines = [ln for ln in text.splitlines() if ln.startswith("vulgar:")]
    assert any(" + 10875 M 2175 2175" in ln for ln in lines)


def test_affine_local_protein_pair():
    import glob
    files = sorted(glob.glob(PROTEIN_DIR + "/*.fasta"))
    assert files
    text = run_cli(["-m", "affine:local", "--showvulgar", "yes",
                    "--showalignment", "no", "--score", "50",
                    files[0], files[0]])
    assert "vulgar:" in text


def test_protein2genome_split_codon_vulgar(tmp_path):
    (tmp_path / "p.fa").write_text(">protein\nMADQLTEQIAEFKEAFSLFDKDGDGTITT\n")
    (tmp_path / "g.fa").write_text(
        ">genome\nATGGCTGACCAGCTGACTGAGCAGATTGCAGAGTTCAA"
        + "GT" + "N" * 43 + "AG"
        + "GGAGGCCTTCTCCCTCTTTGACAAGGATGGAGATGGCACTATTACCACC\n")
    text = run_cli(["-m", "protein2genome", "--showalignment", "no",
                    "--showvulgar", "yes", "--score", "50",
                    str(tmp_path / "p.fa"), str(tmp_path / "g.fa")])
    vulgar = [ln for ln in text.splitlines() if ln.startswith("vulgar:")]
    assert vulgar
    # the golden structure: phase-1 intron with split codons, score 125
    # (ref crib: protein2genome.test.c:34)
    assert vulgar[0] == ("vulgar: protein 0 29 . genome 0 134 + 125 "
                         "M 12 36 S 0 2 5 0 2 I 0 43 3 0 2 S 1 1 M 16 48")


def test_batched_first_path_matches_sequential(tmp_path, monkeypatch):
    """The accelerator's exhaustive route (reduced-space region scan on
    the XLA wavefront, then the path DP on the discovered box) must
    produce byte-identical output to the host route, on a multi-locus
    est2genome locus-heuristic case with subopt enabled."""
    from exonerate_tpu import device, observe
    from exonerate_tpu.seqio import iter_fasta

    calm = str(list(iter_fasta(CALM))[0])
    exon1 = calm[100:350]
    exon2 = calm[350:600]
    intron = "gt" + calm[900:1100] + "ag"
    spacer = calm[1200:1700]
    query = exon1 + exon2
    # two gene loci: one spliced copy, one contiguous copy
    target = spacer + exon1 + intron + exon2 + spacer + query + spacer
    qf, tf = tmp_path / "q.fa", tmp_path / "t.fa"
    qf.write_text(">q\n" + query + "\n")
    tf.write_text(">t\n" + target + "\n")
    args = ["-m", "est2genome", "--showvulgar", "yes",
            "--showalignment", "no", str(qf), str(tf)]
    monkeypatch.setenv("EXONERATE_TPU_HEURISTIC", "locus")
    seq_text = run_cli(args)
    assert not observe.engine_counts.get("xla")
    monkeypatch.setattr(device, "exhaustive_on_device", lambda: True)
    bat_text = run_cli(args)
    assert observe.engine_counts.get("xla")
    assert "vulgar:" in seq_text
    assert len([l for l in seq_text.splitlines()
                if l.startswith("vulgar:")]) >= 2
    assert bat_text == seq_text


def test_heuristic_nonlocal_model_fatal(capsys):
    """(ref: GAM_create, gam.c:417-418): heuristic mode on a non-local
    model must abort with the reference's FATAL ERROR, not silently run
    a heuristic the reference refuses."""
    import pytest
    from exonerate_tpu.cli.exonerate import main
    import io
    with pytest.raises(SystemExit) as e:
        main(["-m", "affine:global",
              DATA + "/cdna/calm.human.dna.fasta",
              DATA + "/cdna/calm.human.dna.fasta"],
             out=io.StringIO())
    assert e.value.code == 1
    assert "Cannot perform heuristic alignments" in capsys.readouterr().err
