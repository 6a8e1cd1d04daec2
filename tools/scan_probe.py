"""Per-platform scan settings, and what XLA makes of each scan.

Times the two device scans of the main path at the smoke's sizes
(chip_smoke.py), on the attached device, against their host C++
counterparts:

- the seeded-DP band scan (engine/sdp_device.py) on the largest bucket
  of the est2genome genome scan (16 cDNAs x 1 Mb), for each fold G in
  --folds, against the native SDP scheduler on the same comparisons;
- the exhaustive wavefront region scan (engine/wavefront.py) on the
  2175 x 2175 CALM self pair, for each unroll in --unrolls, against the
  native dense Viterbi.

Then traces one warm band-scan call at the platform's fold with
jax.profiler and reduces the device events: kernels per scan step and
the idle time per step.  Writes the trace under --out.

    python tools/scan_probe.py [--folds 1,2,4,8] [--unrolls 1,2,4,8]

(an empty list skips that sweep: --folds= --unrolls= only traces)
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# band width of the traced scan (see main)
TRACE_W = 1024


def card() -> str:
    import subprocess
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 \
        else "no nvidia-smi"


def scan_jobs():
    """The est2genome scan's device jobs: (model, [(pair, plan)]),
    captured from the CLI's own pooled path (the device pass is
    skipped: every job reports live, so results come from the host)."""
    import io
    import numpy as np
    from benchmarks import fixtures
    from exonerate_tpu.cli.exonerate import main
    from exonerate_tpu.engine import sdp_hybrid
    qf, tf, _ = fixtures.scan_inputs()
    got = []

    def capture(model, jobs):
        got.append((model, jobs))
        return [{"band_end": np.zeros(len(p.loci) + 1, np.int64),
                 "live": True, "xband": False} for _, p in jobs]
    saved = sdp_hybrid.run_device_batch
    sdp_hybrid.run_device_batch = capture
    os.environ["EXONERATE_TPU_SDP"] = "device"
    try:
        main(["-m", "est2genome", "--bestn", "1", "--maxintron", "20000",
              "--showvulgar", "yes", "--showalignment", "no", qf, tf],
             out=io.StringIO())
    finally:
        sdp_hybrid.run_device_batch = saved
        os.environ.pop("EXONERATE_TPU_SDP")
    return got[0]


def biggest_bucket(model, jobs):
    """Stacked inputs of the largest (by padded width) bucket, bucketed
    as sdp_hybrid.run_device_batch does."""
    import numpy as np
    from exonerate_tpu.engine import sdp_device
    from exonerate_tpu.engine.sdp_hybrid import _pow2
    from exonerate_tpu.engine.wavefront import _bucket
    mq = max(p.region.query_length for p, _ in jobs)
    ms = max(len(p.seeds) for p, _ in jobs)
    mg = max(len(pl.loci) + 1 for _, pl in jobs)
    buckets: dict = {}
    for pair, plan in jobs:
        Qp, Wp = _bucket(mq), _pow2(max(plan.W, 1024))
        inputs, kinds = sdp_device.prepare_inputs(model, pair, plan,
                                                  pad_to=(Qp, Wp))
        inputs.update(sdp_device.prepare_seeds(pair, plan, _pow2(ms)))
        key = (Qp, Wp, kinds, pair.use_boundary, _pow2(ms), _pow2(mg),
               pair.args.dropoff)
        buckets.setdefault(key, []).append((pair, plan, inputs))
    key = max(buckets, key=lambda k: (k[1], len(buckets[k])))
    items = buckets[key]
    import jax
    stacked = jax.tree_util.tree_map(lambda *xs: np.stack(xs),
                                     *[it[2] for it in items])
    return key, items, stacked


def timed(fn, *args, reps=2):
    """(first-call seconds incl. compile, best warm seconds)."""
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    cold = time.perf_counter() - t0
    warm = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        warm.append(time.perf_counter() - t0)
    return cold, min(warm)


def reduce_trace(trace_dir: str, n_steps: int) -> dict:
    """Device events of the traced window: per device line, the event
    count, busy seconds and window span; kernels and idle per step
    from the busiest line."""
    from jax.profiler import ProfileData
    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    pd = ProfileData.from_file(sorted(paths)[-1])
    lines = {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            ev = [(e.start_ns, e.duration_ns) for e in line.events]
            if not ev:
                continue
            ev.sort()
            busy, end = 0, ev[0][0]
            for s, d in ev:                   # union of intervals
                if s + d > end:
                    busy += s + d - max(s, end)
                    end = s + d
            span = max(s + d for s, d in ev) - ev[0][0]
            lines[f"{plane.name} | {line.name}"] = {
                "events": len(ev), "busy_s": busy / 1e9,
                "span_s": span / 1e9}
    if not lines:
        return {"lines": {}, "planes": [p.name for p in pd.planes]}
    name = max(lines, key=lambda k: lines[k]["events"])
    top = lines[name]
    return {"lines": lines, "kernel_line": name,
            "kernels_per_step": top["events"] / n_steps,
            "idle_share": 1 - top["busy_s"] / top["span_s"],
            "idle_us_per_step": (top["span_s"] - top["busy_s"])
            / n_steps * 1e6,
            "busy_us_per_step": top["busy_s"] / n_steps * 1e6}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--folds", default="1,2,4,8")
    ap.add_argument("--unrolls", default="1,2,4,8")
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "scan_probe"))
    a = ap.parse_args()
    import jax
    import numpy as np
    import exonerate_tpu
    from exonerate_tpu import device
    exonerate_tpu.enable_compilation_cache()
    from exonerate_tpu.engine import sdp_device, sdp_native, wavefront
    from exonerate_tpu.engine.region import Region
    from exonerate_tpu.engine.sdp import SDPPair
    from exonerate_tpu.engine.subopt import SubOpt
    from benchmarks import fixtures
    from exonerate_tpu.model.data import AlignData
    from exonerate_tpu.model.est2genome import est2genome_create
    from exonerate_tpu.seqio import iter_fasta
    tag = card()
    res = {"card": tag, "device": device.describe(), "band_scan": {},
           "wavefront": {}}
    os.makedirs(a.out, exist_ok=True)

    model, jobs = scan_jobs()
    key, items, stacked = biggest_bucket(model, jobs)
    Qp, Wp, kinds, ub, nsp, ngp, dropoff = key
    n_steps = Qp + Wp + 1
    res["band_scan"]["bucket"] = {"Qp": Qp, "Wp": Wp, "batch": len(items),
                                  "jobs_in_scan": len(jobs)}
    t0 = time.perf_counter()
    for pair, plan, _ in items:
        host = SDPPair(model, pair.comparison, pair.data, SubOpt(),
                       pair.args)
        host._find_starts()
        host._find_ends()
    res["band_scan"]["host_native_s"] = time.perf_counter() - t0
    dev_in = jax.device_put(stacked)
    ref = None
    for G in [int(x) for x in a.folds.split(",") if x]:
        fn = jax.jit(jax.vmap(sdp_device.build_pass(
            model, Qp, Wp, kinds, ub, nsp, ngp, dropoff, fold=G)))
        cold, warm = timed(fn, dev_in)
        out = jax.tree_util.tree_map(np.asarray, fn(dev_in))
        if ref is None:
            ref = out
        same = all(np.array_equal(out[k], ref[k]) for k in ref)
        res["band_scan"][f"fold{G}"] = {"first_call_s": cold,
                                        "warm_s": warm,
                                        "equal_to_first": same}
        print(tag, "band scan", Qp, Wp, len(items), "fold", G, cold, warm,
              same, flush=True)

    calm = list(iter_fasta(fixtures.calm_path()))[0]
    calm.strand = "+"
    emodel = est2genome_create()
    data = AlignData(calm, calm)
    region = Region(0, 0, len(calm), len(calm))
    t0 = time.perf_counter()
    host = sdp_native.run_viterbi(emodel, region, data, "region")
    res["wavefront"]["host_native_s"] = time.perf_counter() - t0
    inputs, wkinds = wavefront.prepare_inputs(emodel, region, data)
    win = jax.device_put(inputs)
    for U in [int(x) for x in a.unrolls.split(",") if x]:
        fn = jax.jit(wavefront.build_wavefront(emodel, len(calm),
                                               len(calm), "region",
                                               wkinds, unroll=U))
        cold, warm = timed(fn, win)
        out = {k: int(v) for k, v in fn(win).items()}
        same = (out["score"], out["query_end"], out["target_end"],
                out["query_start"], out["target_start"]) == \
            (host.score, host.query_end, host.target_end,
             host.query_start, host.target_start)
        res["wavefront"][f"unroll{U}"] = {"first_call_s": cold,
                                          "warm_s": warm,
                                          "equal_to_native": same}
        print(tag, "wavefront 2175^2 unroll", U, cold, warm, same,
              flush=True)

    # one traced warm band-scan call at the platform's fold, on the
    # bucket's first TRACE_W columns: every step runs the same kernels
    # whatever the width, and the full scan's millions of kernel
    # events overflow the profiler's buffers
    G = device.sdp_fold()
    tw = min(Wp, TRACE_W)
    narrow = jax.tree_util.tree_map(
        lambda x: x[:, :tw + 1] if x.ndim > 1 and x.shape[1] == Wp + 1
        else x, stacked)
    fn = jax.jit(jax.vmap(sdp_device.build_pass(
        model, Qp, tw, kinds, ub, nsp, ngp, dropoff, fold=G)))
    narrow = jax.device_put(narrow)
    jax.block_until_ready(fn(narrow))
    tdir = os.path.join(a.out, "trace")
    with jax.profiler.trace(tdir):
        jax.block_until_ready(fn(narrow))
    # both passes (reverse + forward) step ceil(steps / G) times
    res["trace"] = reduce_trace(tdir, 2 * (-(-(Qp + tw + 1) // G)))
    res["trace"].update(fold=G, Qp=Qp, W=tw, batch=len(items))
    with open(os.path.join(a.out, "scan_probe.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({k: v for k, v in res.items() if k != "trace"}))
    print(json.dumps({k: v for k, v in res["trace"].items()
                      if k != "lines"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
