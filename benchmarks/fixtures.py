"""Inputs rebuilt from files committed in the repo, from a seed.

Every workload the tests, the bench and the chip smoke run is made here:

- the reference test corpus (four cDNAs and their proteins).  The cDNA
  files are the records of ``tests/golden/data/all4.fa``, which is the
  byte-for-byte concatenation of the corpus's cDNA files; each protein
  is the translation of its cDNA's coding span (the CDS coordinates the
  cDNA headers and the goldens give);
- the genome-scan workloads of BASELINE.json (config 5: mutated cDNAs
  against a synthetic genome with gene copies; config 6: mutated CALM
  proteins against the same genome).

Files are written atomically and only when their bytes change, so
parallel test workers can share one directory.
"""
from __future__ import annotations

import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
# generated inputs live here (listed in .gitignore)
WORK = os.path.join(REPO, ".fixtures")

# (cDNA file, protein file, protein id, 0-based CDS start, CDS end
# including the stop codon), in the corpus's sorted file order
CORPUS = [
    ("calm.human.dna.fasta", "calm.human.protein.fasta", "CALM_HUMAN",
     103, 553),
    ("htrt.human.dna.fasta", "htrt.human.protein.fasta", "AF01595",
     55, 3454),
    ("p53.human.dna.fasta", "p53.human.protein.fasta", "P53_HUMAN",
     214, 1396),
    ("tube.drome.dna.fasta", "tube.drome.protein.fasta", "TUBE_DROME",
     193, 1582),
]


def write_atomic(path: str, text: str) -> str:
    """Write ``text`` to ``path`` unless it already holds exactly that."""
    try:
        with open(path) as f:
            if f.read() == text:
                return path
    except OSError:
        pass
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)
    return path


def fasta_text(entries, width: int = 60) -> str:
    out = []
    for name, seq in entries:
        out.append(">" + name + "\n")
        out.extend(seq[i:i + width] + "\n"
                   for i in range(0, len(seq), width))
    return "".join(out)


def _all4_records() -> list[str]:
    """The raw text of each record of all4.fa (header + lines)."""
    recs: list[list[str]] = []
    with open(os.path.join(GOLDEN, "data", "all4.fa")) as f:
        for ln in f:
            if ln.startswith(">"):
                recs.append([ln])
            else:
                recs[-1].append(ln)
    return ["".join(r) for r in recs]


def _seq_of(record: str) -> str:
    return "".join(ln.strip() for ln in record.splitlines()[1:])


def corpus_texts() -> dict[str, str]:
    """{'cdna/<file>': text, 'protein/<file>': text} for the corpus."""
    from exonerate_tpu.translate import default_code
    code = default_code()
    out = {}
    for rec, (dna_f, prot_f, pid, s, e) in zip(_all4_records(), CORPUS):
        out["cdna/" + dna_f] = rec
        prot = code.translate_str(_seq_of(rec)[s:e])
        assert prot.endswith("*") and "*" not in prot[:-1], dna_f
        out["protein/" + prot_f] = fasta_text([(pid, prot[:-1])])
    return out


def corpus_dir(root: str = WORK) -> str:
    """Write the corpus under ``root/corpus`` and return that dir."""
    d = os.path.join(root, "corpus")
    for rel, text in corpus_texts().items():
        write_atomic(os.path.join(d, rel), text)
    return d


def calm_cdna() -> str:
    """The CALM cDNA sequence (2175 nt, upper case)."""
    return _seq_of(_all4_records()[0])


def calm_protein() -> str:
    """The CALM protein (149 aa): translation of CDS 104->553."""
    text = corpus_texts()["protein/calm.human.protein.fasta"]
    return _seq_of(text)


def calm_path(root: str = WORK) -> str:
    return os.path.join(corpus_dir(root), "cdna", "calm.human.dna.fasta")


# ---------------------------------------------------------------------------
# genome-scan workloads (BASELINE.json configs 5 and 6)
# ---------------------------------------------------------------------------

def synthesize(n_genes: int, genome_len: int, rng):
    """Random genome holding ``n_genes`` copies of the first 1200 nt of
    the CALM cDNA, split in three exons by GT..AG introns and mutated
    ~1% per copy.  Returns (cdna, genome, loci)."""
    cdna = calm_cdna()[:1200]
    exons = [cdna[:400], cdna[400:800], cdna[800:]]
    genome = rng.choice(list("acgt"), genome_len).tolist()
    spacing = genome_len // (n_genes + 1)
    loci = []
    for g in range(n_genes):
        pos = spacing * (g + 1)
        start = pos
        for i, exon in enumerate(exons):
            ex = list(exon)
            for _ in range(len(ex) // 100):
                ex[rng.integers(0, len(ex))] = rng.choice(list("ACGT"))
            genome[pos:pos + len(ex)] = ex
            pos += len(ex)
            if i < len(exons) - 1:
                ilen = int(rng.integers(200, 1200))
                intron = ["g", "t"] + rng.choice(
                    list("acgt"), ilen - 4).tolist() + ["a", "g"]
                genome[pos:pos + ilen] = intron
                pos += ilen
        loci.append((start, pos))
    return cdna, "".join(genome), loci


def _mutated_proteins(n: int, seed: int = 13) -> str:
    prot = calm_protein()
    rng = np.random.default_rng(seed)
    aas = list("ACDEFGHIKLMNPQRSTVWY")
    out = []
    for i in range(n):
        p = list(prot)
        for _ in range(len(p) // 20):        # ~5% substitutions
            p[int(rng.integers(0, len(p)))] = str(rng.choice(aas))
        out.append(f">p{i}\n{''.join(p)}\n")
    return "".join(out)


def scan_inputs(root: str = WORK, n_genes: int = 8, n_queries: int = 16,
                genome_mb: float = 1.0) -> tuple[str, str, int]:
    """Config 5: ``n_queries`` mutated cDNAs (~2%) against a synthetic
    genome.  Returns (query fasta, genome fasta, n_queries)."""
    d = os.path.join(root, f"scan_{n_genes}g_{n_queries}q_{genome_mb}mb")
    rng = np.random.default_rng(7)
    cdna, genome, _ = synthesize(n_genes, int(genome_mb * 1e6), rng)
    queries = []
    for i in range(n_queries):
        q = list(cdna)
        for _ in range(len(q) // 50):
            q[rng.integers(0, len(q))] = rng.choice(list("ACGT"))
        queries.append(f">q{i}\n{''.join(q)}\n")
    qf = write_atomic(os.path.join(d, "q.fa"), "".join(queries))
    # 60-column lines: the C fasta2esd/esd2esi index builders need
    # regular FASTA line lengths
    tf = write_atomic(os.path.join(d, "t.fa"),
                      fasta_text([("genome", genome)]))
    return qf, tf, n_queries


def p2g_inputs(root: str = WORK, n_queries: int = 8, **scan_kw
               ) -> tuple[str, str, int]:
    """Config 6: ``n_queries`` mutated CALM proteins (~5%) against the
    scan genome.  Returns (protein fasta, genome fasta, n_queries)."""
    _qf, tf, _ = scan_inputs(root, **scan_kw)
    pf = write_atomic(os.path.join(os.path.dirname(tf),
                                   f"p{n_queries}.fa"),
                      _mutated_proteins(n_queries))
    return pf, tf, n_queries


def split_fasta(path: str, n: int) -> list[str]:
    """Split a FASTA into ``n`` part files, round-robin by record."""
    recs: list[list[str]] = []
    with open(path) as f:
        for ln in f:
            if ln.startswith(">"):
                recs.append([ln])
            elif recs:
                recs[-1].append(ln)
    return [write_atomic(f"{path}.part{k}",
                         "".join("".join(r) for r in recs[k::n]))
            for k in range(n)]
