"""Chip smoke: the main path on one GPU, checked byte for byte.

    python chip_smoke.py                # one card
    python chip_smoke.py --four-cards   # 4 processes, one per card

With no option it drives the exonerate CLI and server on one card, at
the sizes of BASELINE.json configs 5 and 6, and checks every output
against the C reference binary (build/ref/bin/exonerate-fast) run on
the same files in the same call:

1. refuse anything but a GPU, and a failed native (C++) build;
2. build the inputs from the repo (benchmarks/fixtures.py);
3. est2genome scan: 16 mutated cDNAs x 1 Mb genome, default routing;
   the band scans must run on the device (engine counter sdp-device);
4. protein2genome scan: 8 mutated CALM proteins x the same genome, by
   default and with EXONERATE_TPU_SDP=device;
5. exhaustive est2genome, CALM cDNA against itself (2175 x 2175);
6. kernel-level parity at these widths: the device band scans of
   phase 3 against the host SDP engine, and the device wavefront
   region scan against the native dense Viterbi (int32, tolerance 0);
7. a resident ExonerateServer in this process answers the phase-3
   queries from its client; its output must equal phase 3's.

With --four-cards it runs the est2genome scan as one 4-process
``--multihost query`` job, one process per card, and checks the merged
output against the C binary's single run; nothing else.

Every line before the last names the card and its power limit.  The
last line is {"ok": true, "device": {...}}; any failed check exits
non-zero without it.
"""
from __future__ import annotations

import argparse
import io
import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
C_EXONERATE = os.path.join(REPO, "build", "ref", "bin", "exonerate-fast")
SCAN_ARGS = ["-m", "est2genome", "--bestn", "1", "--maxintron", "20000",
             "--showvulgar", "yes", "--showalignment", "no"]
P2G_ARGS = ["-m", "protein2genome", "--bestn", "1", "--maxintron",
            "20000", "--showvulgar", "yes", "--showalignment", "no"]
EXH_ARGS = ["-m", "est2genome", "-E", "yes", "--bestn", "1",
            "--showvulgar", "yes", "--showalignment", "no"]
N_CARDS = 4

CARD = ""


def log(msg: str) -> None:
    print(f"[{CARD}] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cards() -> list[str]:
    """`name, power.limit` of each card, as nvidia-smi reports them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60)
    except FileNotFoundError:
        fail("nvidia-smi not found: no NVIDIA driver on this machine")
    if r.returncode:
        fail(f"nvidia-smi: {r.stderr.strip()}")
    return [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]


def body(text: str) -> str:
    """Output after the `Command line:` and `Hostname:` lines."""
    lines = text.splitlines(keepends=True)
    if len(lines) < 2 or not lines[0].startswith("Command line:") \
            or not lines[1].startswith("Hostname:"):
        fail(f"unexpected output head: {lines[:2]!r}")
    return "".join(lines[2:])


def run_c(argv: list[str]) -> tuple[str, float]:
    t0 = time.perf_counter()
    r = subprocess.run([C_EXONERATE] + argv, capture_output=True,
                       text=True, timeout=900)
    dt = time.perf_counter() - t0
    if r.returncode:
        fail(f"exonerate-fast {argv}: rc {r.returncode}: {r.stderr[-500:]}")
    return body(r.stdout), dt


def same(name: str, ours: str, ref: str) -> None:
    if ours != ref:
        import difflib
        diff = "".join(list(difflib.unified_diff(
            ref.splitlines(True), ours.splitlines(True),
            "reference", "exonerate_tpu"))[:40])
        fail(f"{name}: output differs from the reference\n{diff}")
    n = sum(1 for ln in ours.splitlines() if ln.startswith("vulgar:"))
    log(f"{name}: byte-identical to the reference ({n} vulgar lines)")


class CompileClock:
    """Seconds XLA spent compiling, from JAX's monitoring events."""

    def __init__(self):
        import jax
        from jax._src import dispatch
        self.seconds = 0.0
        event = dispatch.BACKEND_COMPILE_EVENT

        def on_event(ev, secs, **_kw):
            if ev == event:
                self.seconds += secs
        jax.monitoring.register_event_duration_secs_listener(on_event)


def run_cli(name: str, argv: list[str], env: dict | None = None,
            runs: int = 2) -> tuple[str, dict]:
    """Run our CLI `runs` times (cold, then warm) in this process and
    return the output body and the last run's engine counts; every
    run must give the same bytes."""
    from exonerate_tpu import observe
    from exonerate_tpu.cli.exonerate import main
    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        texts = []
        for label in ("cold", "warm")[:runs]:
            buf = io.StringIO()
            t0 = time.perf_counter()
            rc = main(list(argv), out=buf)
            dt = time.perf_counter() - t0
            if rc:
                fail(f"{name}: exit code {rc}")
            texts.append(body(buf.getvalue()))
            log(f"{name} {label}: {dt:.3f} s; engines "
                f"{dict(sorted(observe.engine_counts.items()))}; "
                f"fallbacks {dict(sorted(observe.fallback_counts.items()))}")
        if any(t != texts[0] for t in texts):
            fail(f"{name}: cold and warm outputs differ")
        return texts[0], dict(observe.engine_counts)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def check_band_scans(recorded: list) -> None:
    """Device band-scan outputs vs the host SDP engine on the same
    comparisons: per-locus best end score and (non-boundary models)
    per-seed start score must be equal; a scan flagged live or
    cross-locus must never overcount (the hybrid then reruns it on the
    host, so parity holds either way)."""
    import numpy as np
    from exonerate_tpu.engine.sdp import SDPPair
    from exonerate_tpu.engine.subopt import SubOpt
    n_jobs = n_exact = n_flagged = 0
    for model, jobs, outs in recorded:
        for (gpair, plan), out in zip(jobs, outs):
            host = SDPPair(model, gpair.comparison, gpair.data, SubOpt(),
                           gpair.args)
            host._find_starts()
            host._find_ends()
            want = np.array([max(s.max_end.score
                                 for s in host.seeds[lc.seed_lo:lc.seed_hi])
                             for lc in plan.loci], np.int64)
            got = np.asarray(out["band_end"][:len(plan.loci)], np.int64)
            n_jobs += 1
            if bool(out["live"]) or bool(out["xband"]):
                n_flagged += 1
                if not np.all(got <= want):
                    fail(f"band scan overcounts: {got} > {want}")
                continue
            if not np.array_equal(got, want):
                fail(f"band_end {got.tolist()} != host {want.tolist()} "
                     f"(W={plan.W}, Q={gpair.region.query_length})")
            if "start_scores" in out:
                ws = np.array([s.max_start.score for s in host.seeds])
                gs = np.asarray(out["start_scores"][:len(host.seeds)])
                if not np.array_equal(gs, ws):
                    fail("start_scores differ from the host engine")
            n_exact += 1
    if not n_jobs:
        fail("no band scan ran on the device")
    log(f"band scans vs host SDP engine (int32, tolerance 0): "
        f"{n_exact} of {n_jobs} comparisons exact (band_end, live, xband, "
        f"start_scores); {n_flagged} flagged live/cross-locus, none "
        f"overcounting")


def check_wavefront(calm_path: str) -> None:
    """Device wavefront region scan vs the native dense Viterbi on the
    2175 x 2175 CALM self pair (int32, tolerance 0)."""
    from exonerate_tpu.engine import sdp_native, wavefront
    from exonerate_tpu.engine.region import Region
    from exonerate_tpu.model.data import AlignData
    from exonerate_tpu.model.est2genome import est2genome_create
    from exonerate_tpu.seqio import iter_fasta
    calm = list(iter_fasta(calm_path))[0]
    calm.strand = "+"
    model = est2genome_create()
    data = AlignData(calm, calm)
    region = Region(0, 0, len(calm), len(calm))
    t0 = time.perf_counter()
    dev = wavefront.find_region(model, region, data)
    dt = time.perf_counter() - t0
    host = sdp_native.run_viterbi(model, region, data, "region")
    key = lambda r: (r.score, r.query_start, r.target_start,
                     r.query_end, r.target_end)
    if host is None or key(dev) != key(host):
        fail(f"wavefront region {key(dev)} != native "
             f"{None if host is None else key(host)}")
    log(f"wavefront region scan {len(calm)}x{len(calm)} on the device "
        f"({dt:.3f} s) == native dense Viterbi: score, start, end "
        f"{key(dev)} (int32, tolerance 0)")


def serve_scan(qf: str, tf: str) -> str:
    """The phase-3 queries through a resident ExonerateServer in this
    process; returns the client's output body."""
    from exonerate_tpu.cli.server import ExonerateServer
    from exonerate_tpu.db.dataset import dataset_build
    from exonerate_tpu.db.index import Index, index_build
    esd, esi = tf + ".esd.npz", tf + ".esi.npz"
    t0 = time.perf_counter()
    dataset_build([tf], esd)
    index_build(esd, esi)
    index = Index(esi)
    log(f"server index build: {time.perf_counter() - t0:.3f} s")
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    srv = ExonerateServer(index.dataset, index, port)
    srv.start_background()
    try:
        text, _ = run_cli("server scan", SCAN_ARGS + [qf,
                                                      f"localhost:{port}"])
    finally:
        srv.shutdown()
    return text


def require_gpu(count: int) -> None:
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        fail(f"no GPU: JAX runs on {devs[0].platform!r}")
    if len(devs) != count:
        fail(f"expected {count} GPU, JAX sees {len(devs)} "
             "(set CUDA_VISIBLE_DEVICES)")


def one_card() -> dict:
    import jax
    sys.path.insert(0, REPO)
    import exonerate_tpu
    from exonerate_tpu import device, native
    from exonerate_tpu.engine import sdp_hybrid, sdp_native
    from benchmarks import fixtures
    cache = exonerate_tpu.enable_compilation_cache()
    clock = CompileClock()
    desc = device.describe()
    log(f"JAX {jax.__version__}, device {desc}, compile cache {cache}")
    if native.get_lib() is None or sdp_native.get_lib() is None:
        fail("native C++ libraries did not build or load")

    t0 = time.perf_counter()
    qf, tf, nq = fixtures.scan_inputs()
    pf, _tf, npq = fixtures.p2g_inputs()
    calm = fixtures.calm_path()
    log(f"inputs: {nq} cDNAs + {npq} proteins x 1 Mb genome "
        f"({time.perf_counter() - t0:.3f} s)")

    # phase 3: est2genome scan, default routing
    recorded = []
    batch = sdp_hybrid.run_device_batch

    def recording_batch(model, jobs):
        outs = batch(model, jobs)
        recorded.append((model, jobs, outs))
        return outs
    sdp_hybrid.run_device_batch = recording_batch
    try:
        scan, engines = run_cli("est2genome scan", SCAN_ARGS + [qf, tf])
    finally:
        sdp_hybrid.run_device_batch = batch
    if not engines.get("sdp-device"):
        fail(f"est2genome scan ran no band scan on the device: {engines}")
    ref, c_dt = run_c(SCAN_ARGS + [qf, tf])
    log(f"exonerate-fast est2genome scan: {c_dt:.3f} s")
    same("est2genome scan", scan, ref)

    # phase 4: protein2genome scan, default and forced device tier
    p2g, _ = run_cli("protein2genome scan", P2G_ARGS + [pf, tf])
    p2g_dev, engines = run_cli("protein2genome scan, device tier",
                               P2G_ARGS + [pf, tf],
                               env={"EXONERATE_TPU_SDP": "device"})
    if not engines.get("sdp-device"):
        fail(f"forced protein2genome ran no device band scan: {engines}")
    ref, c_dt = run_c(P2G_ARGS + [pf, tf])
    log(f"exonerate-fast protein2genome scan: {c_dt:.3f} s")
    same("protein2genome scan", p2g, ref)
    same("protein2genome scan, device tier", p2g_dev, ref)

    # phase 5: exhaustive est2genome on the CALM self pair
    exh, engines = run_cli("exhaustive est2genome 2175x2175",
                           EXH_ARGS + [calm, calm])
    if not engines.get("xla"):
        fail(f"exhaustive run did not reach the device: {engines}")
    ref, c_dt = run_c(EXH_ARGS + [calm, calm])
    log(f"exonerate-fast exhaustive est2genome: {c_dt:.3f} s")
    same("exhaustive est2genome 2175x2175", exh, ref)

    # phase 6: kernel-level parity at real widths
    check_band_scans(recorded)
    check_wavefront(calm)

    # phase 7: resident server, client in this process
    same("server scan (vs phase 3)", serve_scan(qf, tf), scan)

    stats = jax.devices()[0].memory_stats() or {}
    log(f"compile seconds (XLA backend compiles, this process): "
        f"{clock.seconds:.3f}")
    log(f"peak_bytes_in_use on this card: "
        f"{stats.get('peak_bytes_in_use', 'not reported')}")
    return desc


def four_cards() -> dict:
    """The est2genome scan as one --multihost query job over 4 processes
    (one card each); the merged report must equal the C binary's single
    run.  This process stays off JAX: each child owns its card."""
    sys.path.insert(0, REPO)
    from benchmarks import fixtures
    if len(cards()) < N_CARDS:
        fail(f"--four-cards needs {N_CARDS} cards, nvidia-smi shows "
             f"{len(cards())}")
    qf, tf, nq = fixtures.scan_inputs()
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    out_dir = os.path.join(fixtures.WORK, "four_cards")
    os.makedirs(out_dir, exist_ok=True)
    report = os.path.join(out_dir, "rank0.json")
    if os.path.exists(report):
        os.unlink(report)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(k),
         "--coordinator", f"localhost:{port}", "--report", report,
         qf, tf],
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=str(k)))
        for k in range(N_CARDS)]
    try:
        rcs = [p.wait(timeout=1000) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    dt = time.perf_counter() - t0
    if any(rcs):
        fail(f"--multihost processes exited {rcs}")
    with open(report) as f:
        rank0 = json.load(f)
    log(f"4-process --multihost query est2genome scan: {dt:.3f} s "
        f"(process start, compile and run; rank 0 run "
        f"{rank0['seconds']:.3f} s, engines {rank0['engines']})")
    if not rank0["engines"].get("sdp-device"):
        fail(f"rank 0 ran no band scan on the device: {rank0['engines']}")
    ref, c_dt = run_c(SCAN_ARGS + [qf, tf])
    log(f"exonerate-fast est2genome scan (one process): {c_dt:.3f} s")
    same("4-card merged est2genome scan", rank0["text"], ref)
    return rank0["device"]


def rank_main(rank: int, coordinator: str, report: str, qf: str,
              tf: str) -> None:
    """One process of the 4-card job: its card, its query chunk."""
    sys.path.insert(0, REPO)
    import exonerate_tpu
    from exonerate_tpu import device, observe
    from exonerate_tpu.cli.exonerate import main
    exonerate_tpu.enable_compilation_cache()
    buf = io.StringIO()
    t0 = time.perf_counter()
    rc = main(SCAN_ARGS + [qf, tf, "--multihost", "query",
                           "--coordinator", coordinator,
                           "--processcount", str(N_CARDS),
                           "--processid", str(rank)], out=buf)
    dt = time.perf_counter() - t0
    desc = device.describe()
    if rc or desc["platform"] != "gpu" or desc["count"] != N_CARDS:
        fail(f"rank {rank}: rc {rc}, devices {desc}")
    if rank == 0:
        with open(report, "w") as f:
            json.dump({"text": body(buf.getvalue()), "seconds": dt,
                       "engines": dict(observe.engine_counts),
                       "device": desc}, f)


def main() -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run the 4-process --multihost path only")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--coordinator", help=argparse.SUPPRESS)
    ap.add_argument("--report", help=argparse.SUPPRESS)
    ap.add_argument("inputs", nargs="*", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.rank is not None:
        rank_main(a.rank, a.coordinator, a.report, *a.inputs)
        return 0
    if a.four_cards:
        CARD = "; ".join(cards()[:N_CARDS])
        desc = four_cards()
    else:
        require_gpu(1)
        CARD = cards()[0]
        desc = one_card()
    log(f"card: {CARD}")
    print(json.dumps({"ok": True, "device": {
        "platform": desc["platform"], "kind": desc["kind"],
        "count": desc["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
