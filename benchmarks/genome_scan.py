"""Heuristic multi-query genome scan benchmark (BASELINE.json config #5).

Synthesizes a genome with gene copies of the calm.human cDNA (exons
split by introns, mutated per gene) embedded in random background
(benchmarks/fixtures.py), then runs the full heuristic pipeline —
seeding, band planning, device band scans and host locus resolution —
for a batch of mutated query cDNAs.

Reports queries/s, alignments found, and recall (every query must map
to a locus with an intron-containing vulgar line).

Usage: python benchmarks/genome_scan.py [n_genes] [n_queries] [genome_mb]
"""
from __future__ import annotations

import io
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(n_genes=8, n_queries=16, genome_mb=1.0):
    import exonerate_tpu
    from benchmarks import fixtures
    from exonerate_tpu.cli.exonerate import main as exonerate_main

    exonerate_tpu.enable_compilation_cache()
    qf, tf, _ = fixtures.scan_inputs(n_genes=n_genes, n_queries=n_queries,
                                     genome_mb=genome_mb)
    args = ["-m", "est2genome", "--bestn", "1", "--maxintron", "20000",
            "--showvulgar", "yes", "--showalignment", "no", qf, tf]
    t0 = time.time()
    out = io.StringIO()
    exonerate_main(args, out=out)
    dt = time.time() - t0
    text = out.getvalue()
    vulgar = [ln for ln in text.splitlines() if ln.startswith("vulgar:")]
    with_intron = [ln for ln in vulgar if " I " in ln]
    hit_queries = {ln.split()[1] for ln in vulgar}
    print(f"genome {genome_mb:.1f} Mb, {n_genes} genes, "
          f"{n_queries} queries")
    print(f"wall {dt:.1f}s  ->  {n_queries/dt:.2f} queries/s")
    print(f"alignments: {len(vulgar)} ({len(with_intron)} spliced), "
          f"recall {len(hit_queries)}/{n_queries}")
    assert len(hit_queries) == n_queries, "missed queries"
    assert with_intron, "no spliced alignments found"
    return 0


if __name__ == "__main__":
    a = [float(x) for x in sys.argv[1:]]
    sys.exit(main(int(a[0]) if a else 8,
                  int(a[1]) if len(a) > 1 else 16,
                  a[2] if len(a) > 2 else 1.0))
