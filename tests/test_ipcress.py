"""ipcress integration test (ref: test/ipcress/ipcress.simple.test.sh)."""
import io

from exonerate_tpu.cli.ipcress import main

from benchmarks.fixtures import corpus_dir

DATA = corpus_dir()

CALM = DATA + "/cdna/calm.human.dna.fasta"


def test_ipcress_simple(tmp_path):
    exp = tmp_path / "test.ipcress"
    exp.write_text("test_primer CGCGGACGCGCG GTATTTTATTGG 2000 2500\n")
    out = io.StringIO()
    assert main([str(exp), CALM], out=out) == 0
    lines = [ln for ln in out.getvalue().splitlines()
             if ln.startswith("ipcress:")]
    assert len(lines) == 1  # exactly one product, as in the reference
    fields = lines[0].split()
    # the PCR scan runs on the unmasked filter view, which renames the
    # id (ref: ipcress.c:298, sequence.c:453-460)
    assert fields[1] == "EMBL:J04046:filter(unmasked)"
    assert fields[2] == "test_primer"
    assert fields[10] == "forward"


def test_ipcress_products_and_mismatch(tmp_path):
    exp = tmp_path / "test.ipcress"
    exp.write_text("test_primer CGCGGACGCGCG GTATTTTATTGG 2000 2500\n")
    out = io.StringIO()
    main(["-m", "1", "-P", "TRUE", "--pretty", "FALSE", str(exp), CALM],
         out=out)
    text = out.getvalue()
    assert ">test_primer_product_1" in text
    assert text.count("ipcress:") >= 1
