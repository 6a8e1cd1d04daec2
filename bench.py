"""Benchmark: the main path's device work and end-to-end runs.

Sections (all by default, or name them: python bench.py [section ...]):

- wavefront: the exhaustive XLA wavefront engine (engine/wavefront.py)
  on est2genome (10 states / 24 transitions / shadow lanes, the spliced
  workhorse) over the CALM self pair (2175 x 2175), a batch of B pairs
  end to end (host prep + transfer + scan + fetch) and with inputs
  pre-staged on the device; GCUPS = cell updates/s (cells = Q * T);
- scan: 16 mutated cDNAs x 1 Mb genome, est2genome heuristic, cold and
  warm (BASELINE.json config 5);
- p2g: 8 mutated CALM proteins x the same genome, protein2genome
  (config 6);
- p2g_scale: 64 proteins x 10 Mb (config 6 at scale);
- serving: a resident ExonerateServer over the indexed 1 Mb genome,
  one in-process client and 4 client processes.

Needs a GPU and fails without one; any failing section fails the run.
Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}
where vs_baseline is the ratio to exonerate-fast's exhaustive run on
the same pair, timed in the same call.
"""
from __future__ import annotations

import io
import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

SECTIONS = ("wavefront", "scan", "p2g", "p2g_scale", "serving")


def _cli(argv, reps: int = 1) -> tuple[float, float, str]:
    """(cold s, best warm s, output) of our CLI in this process."""
    from exonerate_tpu.cli.exonerate import main as exo_main
    t0 = time.perf_counter()
    exo_main(list(argv), out=io.StringIO())
    cold = time.perf_counter() - t0
    best, text = None, ""
    for _ in range(reps):
        out = io.StringIO()
        t0 = time.perf_counter()
        exo_main(list(argv), out=out)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
        text = out.getvalue()
    return cold, best, text


def _n_vulgar(text: str) -> int:
    return sum(1 for ln in text.splitlines() if ln.startswith("vulgar:"))


def _wavefront(extras: dict) -> float:
    """GCUPS of the XLA wavefront region scan on the CALM self pair."""
    import jax
    import numpy as np
    from benchmarks import fixtures
    from exonerate_tpu.engine import wavefront as wf
    from exonerate_tpu.engine.region import Region
    from exonerate_tpu.model.data import AlignData
    from exonerate_tpu.model.est2genome import est2genome_create
    from exonerate_tpu.seqio import iter_fasta
    calm = list(iter_fasta(fixtures.calm_path()))[0]
    calm.strand = "+"
    model = est2genome_create()
    data = AlignData(calm, calm)
    region = Region(0, 0, len(calm), len(calm))
    cells = region.query_length * region.target_length
    B, reps = 8, 3
    jobs = [(region, data)] * B
    wf.find_region_batched(model, jobs)                 # compile
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        res = wf.find_region_batched(model, jobs)
        times.append(time.perf_counter() - t0)
    assert {r.score for r in res} == {10875}, res
    gcups = cells / (min(times) / B) / 1e9
    # device-only: inputs pre-staged, timed call ends in a fetch
    Qp, Tp = wf._bucket(region.query_length), wf._bucket(
        region.target_length)
    inputs, kinds = wf.prepare_inputs(model, region, data, pad_to=(Qp, Tp))
    stacked = jax.device_put(jax.tree_util.tree_map(
        lambda *xs: np.stack(xs), *[inputs] * B))
    fn = wf._get_batched_fn(model, Qp, Tp, "region", kinds)
    jax.block_until_ready(fn(stacked))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(stacked))
        times.append(time.perf_counter() - t0)
    extras["wavefront_device_ms_per_pair"] = min(times) * 1e3 / B
    extras["wavefront_device_gcups"] = cells / (min(times) / B) / 1e9
    # the C reference on the same pair, same call
    c_exo = os.path.join(REPO, "build", "ref", "bin", "exonerate-fast")
    path = fixtures.calm_path()
    t0 = time.perf_counter()
    subprocess.run([c_exo, "-m", "est2genome", "-E", "yes", "-S", "no",
                    "--bestn", "1", "--showalignment", "no", path, path],
                   check=True, capture_output=True, timeout=900)
    extras["c_exhaustive_seconds"] = time.perf_counter() - t0
    extras["c_exhaustive_gcups"] = cells / extras["c_exhaustive_seconds"] \
        / 1e9
    return gcups


def _scan(extras: dict) -> None:
    from benchmarks import fixtures
    from exonerate_tpu import observe
    qf, tf, nq = fixtures.scan_inputs()
    cold, dt, text = _cli(["-m", "est2genome", "--bestn", "1",
                           "--maxintron", "20000", qf, tf,
                           "--showalignment", "no", "--showvulgar", "yes"])
    extras.update(scan_cold_seconds=cold, scan_seconds=dt,
                  scan_queries_per_sec=nq / dt,
                  scan_alignments=_n_vulgar(text),
                  scan_engines=dict(observe.engine_counts))


def _p2g(extras: dict, prefix: str = "p2g", **scale) -> None:
    from benchmarks import fixtures
    from exonerate_tpu import observe
    pf, tf, nq = fixtures.p2g_inputs(**scale)
    cold, dt, text = _cli(["-m", "protein2genome", "--bestn", "1",
                           "--maxintron", "20000", pf, tf,
                           "--showalignment", "no", "--showvulgar", "yes"])
    extras.update({f"{prefix}_cold_seconds": cold,
                   f"{prefix}_seconds": dt,
                   f"{prefix}_queries_per_sec": nq / dt,
                   f"{prefix}_alignments": _n_vulgar(text),
                   f"{prefix}_engines": dict(observe.engine_counts)})


def _serving(extras: dict) -> None:
    """Warm resident-server queries/s: our ExonerateServer owns the
    indexed 1 Mb genome in-process; one client in this process, then 4
    client processes (CPU-only, so this process keeps the card) behind
    a READY/GO barrier, each streaming a quarter of the queries."""
    from benchmarks import fixtures
    from exonerate_tpu.cli.server import ExonerateServer
    from exonerate_tpu.db.dataset import dataset_build
    from exonerate_tpu.db.index import Index, index_build
    qf, tf, nq = fixtures.scan_inputs()
    esd, esi = tf + ".esd.npz", tf + ".esi.npz"
    dataset_build([tf], esd)
    index_build(esd, esi)
    index = Index(esi)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    srv = ExonerateServer(index.dataset, index, port)
    srv.start_background()
    args = ["-m", "est2genome", "--bestn", "1", "--maxintron", "20000",
            "--showalignment", "no", "--showvulgar", "yes"]
    try:
        cold, best, text = _cli(args + [qf, f"localhost:{port}"], reps=3)
        worker_src = (
            "import sys, io, time\n"
            "from exonerate_tpu.cli.exonerate import main as exo_main\n"
            "argv = sys.argv[1:]\n"
            "exo_main(list(argv), out=io.StringIO())\n"
            "print('READY', flush=True)\n"
            "sys.stdin.readline()\n"
            "b = io.StringIO()\n"
            "exo_main(list(argv), out=b)\n"
            "nv = sum(1 for ln in b.getvalue().splitlines()\n"
            "         if ln.startswith('vulgar:'))\n"
            "print(f'DONE {nv}', flush=True)\n")
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
                   EXONERATE_TPU_RESOLVE_THREADS="1")
        procs = [subprocess.Popen(
            [sys.executable, "-c", worker_src] + args
            + [part, f"localhost:{port}"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            env=env) for part in fixtures.split_fasta(qf, 4)]
        try:
            for p in procs:
                line = p.stdout.readline()
                assert line.strip() == "READY", line
            t0 = time.perf_counter()
            for p in procs:
                p.stdin.write("GO\n")
                p.stdin.flush()
            nvs = [int(p.stdout.readline().split()[1]) for p in procs]
            best_c = time.perf_counter() - t0
        finally:
            for p in procs:
                p.stdin.close()
                p.wait(timeout=60)
    finally:
        srv.shutdown()
    extras.update(serving_cold_seconds=cold, serving_seconds=best,
                  serving_queries_per_sec=nq / best,
                  serving_alignments=_n_vulgar(text),
                  serving_concurrent_clients=4,
                  serving_concurrent_seconds=best_c,
                  serving_concurrent_queries_per_sec=nq / best_c,
                  serving_concurrent_alignments=sum(nvs))


def main(argv=None) -> int:
    sections = list(argv if argv is not None else sys.argv[1:]) \
        or list(SECTIONS)
    unknown = set(sections) - set(SECTIONS)
    if unknown:
        raise SystemExit(f"unknown sections {sorted(unknown)}; "
                         f"choose from {SECTIONS}")
    import exonerate_tpu
    exonerate_tpu.enable_compilation_cache()
    from exonerate_tpu import device
    desc = device.describe()
    if desc["platform"] != "gpu":
        raise SystemExit(f"bench.py measures the GPU; JAX runs on "
                         f"{desc['platform']!r}")
    extras: dict = {"device": desc}
    value = None
    for name in sections:
        if name == "wavefront":
            value = _wavefront(extras)
        elif name == "scan":
            _scan(extras)
        elif name == "p2g":
            _p2g(extras)
        elif name == "p2g_scale":
            _p2g(extras, "p2g_scale", n_queries=64, n_genes=40,
                 genome_mb=10.0)
        else:
            _serving(extras)
    line = {
        "metric": "est2genome_wavefront_gcups_gpu",
        "value": value,
        "unit": "GCUPS",
        "vs_baseline": (value / extras["c_exhaustive_gcups"]
                        if value is not None else None),
    }
    line.update(extras)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
