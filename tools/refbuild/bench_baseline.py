"""Measure the single-core C reference baseline (BASELINE.json configs)
using the shim-built binaries (tools/refbuild/build.sh [fast]).

Prints one JSON object of seconds per configuration; inputs come from
benchmarks/fixtures.py.  exonerate-fast (bootstrapper codegen,
-DG_DISABLE_ASSERT -O2) is used when present — that is the reference's
real production configuration.  A ratio against these numbers is only
meaningful when both sides run in the same call on the same machine.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BIN = os.path.join(REPO, "build", "ref", "bin")
FIX = os.path.join(REPO, "tests", "golden", "data")

sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests", "golden"))
from benchmarks import fixtures  # noqa: E402


def exonerate_bin():
    fast = os.path.join(BIN, "exonerate-fast")
    return fast if os.path.exists(fast) else os.path.join(BIN, "exonerate")


def run(cmd, reps=3):
    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=3600)
        dt = time.perf_counter() - t0
        if r.returncode != 0:
            raise RuntimeError(f"{cmd}: rc={r.returncode}\n{r.stderr[-500:]}")
        best = dt if best is None else min(best, dt)
    return best, r.stdout


def _c_serving_baseline(exo, qf, tf, reps=3):
    """Resident C server + C client queries/s on the 1 Mb genome."""
    import socket
    esd, esi = tf + ".esd", tf + ".esi"
    if not os.path.exists(esi):
        subprocess.run([os.path.join(BIN, "fasta2esd"), tf, esd],
                       check=True, capture_output=True, timeout=600)
        subprocess.run([os.path.join(BIN, "esd2esi"), esd, esi],
                       check=True, capture_output=True, timeout=600)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    proc = subprocess.Popen(
        [os.path.join(BIN, "exonerate-server"), esi, "--port", str(port)],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        deadline = time.time() + 60
        while time.time() < deadline:
            try:
                socket.create_connection(("127.0.0.1", port),
                                         timeout=1).close()
                break
            except OSError:
                time.sleep(0.3)
        argv = [exo, "-m", "est2genome", "--bestn", "1", "--maxintron",
                "20000", qf, f"localhost:{port}",
                "--showalignment", "no", "--showvulgar", "yes"]
        best = None
        out = ""
        for _ in range(reps):
            t0 = time.perf_counter()
            r = subprocess.run(argv, capture_output=True, text=True,
                               timeout=900)
            dt = time.perf_counter() - t0
            if r.returncode == 0:
                best = dt if best is None else min(best, dt)
                out = r.stdout
        nv = sum(1 for ln in out.splitlines() if ln.startswith("vulgar:"))
        res = {"seconds": best, "queries": 16,
               "queries_per_sec": 16 / best if best else None,
               "alignments": nv}
        # concurrent clients: the reference server threads per
        # connection (ref: exonerate-server.c:866-877); drive it with 4
        # simultaneous C client processes, 4 queries each, and report
        # aggregate wall-clock queries/s
        import concurrent.futures as cf
        qparts = fixtures.split_fasta(qf, 4)
        def one(part):
            r = subprocess.run(
                [exo, "-m", "est2genome", "--bestn", "1", "--maxintron",
                 "20000", part, f"localhost:{port}",
                 "--showalignment", "no", "--showvulgar", "yes"],
                capture_output=True, text=True, timeout=900)
            return sum(1 for ln in r.stdout.splitlines()
                       if ln.startswith("vulgar:"))
        best_c = None
        for _ in range(reps):
            t0 = time.perf_counter()
            with cf.ThreadPoolExecutor(max_workers=4) as ex:
                nvs = list(ex.map(one, qparts))
            dt = time.perf_counter() - t0
            best_c = dt if best_c is None else min(best_c, dt)
        res["concurrent_clients"] = 4
        res["concurrent_seconds"] = best_c
        res["concurrent_queries_per_sec"] = 16 / best_c
        res["concurrent_alignments"] = sum(nvs)
        return res
    finally:
        proc.kill()
        proc.wait()


def main():
    import cases
    cases.make_fixtures()
    DATA = fixtures.corpus_dir()
    exo = exonerate_bin()
    results = {}
    noal = ["--showalignment", "no", "--showvulgar", "yes"]

    # config 1: affine:local DNA-vs-DNA (exonerate defaults)
    dt, _ = run([exo, "-m", "affine:local",
                 os.path.join(FIX, "cdna_mut.fa"),
                 os.path.join(DATA, "cdna", "calm.human.dna.fasta")] + noal)
    results["affine_local_dna"] = {"seconds": dt}

    # config 2: affine:global + bestfit protein-vs-protein (exhaustive
    # pair DP; blosum62 is the default protein submat)
    t = 0.0
    for variant in ("affine:global", "affine:bestfit"):
        dt, _ = run([exo, "-m", variant, "-E", "yes", "-S", "no",
                     os.path.join(DATA, "protein", "calm.human.protein.fasta"),
                     os.path.join(DATA, "protein", "p53.human.protein.fasta")]
                    + noal)
        t += dt
    results["affine_global_bestfit_prot"] = {"seconds": t}

    # config 3: est2genome spliced alignment to a genomic region
    dt, _ = run([exo, "-m", "est2genome",
                 os.path.join(FIX, "cdna_mut.fa"),
                 os.path.join(FIX, "genome.fa")] + noal)
    results["est2genome_genomic"] = {"seconds": dt}

    # config 4: protein2genome --exhaustive with full traceback
    q, t_ = (os.path.join(DATA, "protein", "calm.human.protein.fasta"),
             os.path.join(FIX, "genome.fa"))
    dt, _ = run([exo, "-m", "protein2genome", "-E", "yes", "-S", "no",
                 q, t_] + noal, reps=1)
    qlen, tlen = 149, 12000
    results["protein2genome_exhaustive"] = {
        "seconds": dt, "cells": qlen * tlen,
        "mcups": qlen * tlen / dt / 1e6}

    # config 5: heuristic multi-query scan (16 mutated cDNAs vs 1 Mb
    # synthetic genome, est2genome)
    qf, tf, nq = fixtures.scan_inputs()
    dt, out = run([exo, "-m", "est2genome", "--bestn", "1",
                   "--maxintron", "20000", qf, tf] + noal, reps=1)
    nvulgar = sum(1 for ln in out.splitlines() if ln.startswith("vulgar:"))
    results["heuristic_genome_scan"] = {
        "seconds": dt, "queries": nq, "queries_per_sec": nq / dt,
        "alignments": nvulgar}

    # config 6 (north star): protein2genome heuristic scan — 8 mutated
    # CALM proteins vs the same 1 Mb genome, bestn 1
    pf, tf2, npq = fixtures.p2g_inputs()
    dt, out = run([exo, "-m", "protein2genome", "--bestn", "1",
                   "--maxintron", "20000", pf, tf2] + noal, reps=3)
    nvulgar = sum(1 for ln in out.splitlines() if ln.startswith("vulgar:"))
    results["p2g_genome_scan"] = {
        "seconds": dt, "queries": npq, "queries_per_sec": npq / dt,
        "alignments": nvulgar}

    # config 8 (north star at device scale, VERDICT r4 #3): 64 mutated
    # CALM proteins vs a 10 Mb genome, protein2genome bestn 1
    pf3, tf3, nsq = fixtures.p2g_inputs(
        n_queries=64, n_genes=40, genome_mb=10.0)
    dt, out = run([exo, "-m", "protein2genome", "--bestn", "1",
                   "--maxintron", "20000", pf3, tf3] + noal, reps=1)
    nvulgar = sum(1 for ln in out.splitlines() if ln.startswith("vulgar:"))
    results["p2g_scale_scan"] = {
        "seconds": dt, "queries": nsq, "queries_per_sec": nsq / dt,
        "alignments": nvulgar}

    # config 7 (serving): resident C exonerate-server over the indexed
    # 1 Mb genome; the C client streams the 16 scan queries against it.
    # queries/s at a warm resident server is the north star's serving
    # metric (ref: exonerate-server.c:315-378)
    try:
        results["serving_genome_scan"] = _c_serving_baseline(exo, qf, tf)
    except Exception as exc:  # noqa: BLE001 — serving needs a port
        results["serving_genome_scan"] = {"error": str(exc)[:200]}

    # headline kernel metric: exhaustive est2genome DP on the 2175x2175
    # calm self-pair = the bench.py workload (region+path, full DP)
    calm = os.path.join(DATA, "cdna", "calm.human.dna.fasta")
    dt, _ = run([exo, "-m", "est2genome", "-E", "yes", "-S", "no",
                 "--bestn", "1", calm, calm] + noal, reps=1)
    cells = 2175 * 2175
    results["est2genome_exhaustive_2175"] = {
        "seconds": dt, "cells": cells, "mcups": cells / dt / 1e6}

    out = {"binary": os.path.basename(exo), "host": "single-core C",
           "results": results}
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
