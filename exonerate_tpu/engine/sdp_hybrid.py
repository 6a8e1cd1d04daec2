"""Hybrid SDP driver: device scores + lazy host band re-runs.

The default heuristic path on the GPU: per comparison, the band-compressed
device scan (sdp_device.py) computes every locus's best end score; the
next_path stream then resolves only the loci that can actually report
(score >= threshold, in best-first order) by re-running the host native
scheduler restricted to that locus's target window — which yields exact
positions and tracebacks at sparse-live-cell cost.  Device and host
scores are cross-checked at every resolution; any disagreement (or an
edge-liveness / cross-locus flag) raises HybridFallback, and the caller
redoes the whole comparison on the host global path — GAM only submits a
comparison's results after the full list is built, so a retry never
double-emits (ref: GAM_Result_submit ordering, gam.c:1252-1275).

Byte parity therefore never depends on the device: the scan is an
accelerator with an exactness proof per run (liveness-clean + score
agreement), not an approximation.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .. import observe
from ..align.alignment import Alignment
from ..model.ir import Model
from .region import Region
from .sdp import NEG, SDPPair, SdpArgs, model_uses_boundary
from . import sdp_bands, sdp_device

# margin of dense band around seed extents; extension escaping it trips
# edge liveness and falls back to the host engine
BAND_MARGIN = 1024


class HybridFallback(Exception):
    """Device result unusable for this comparison; redo on host."""


def eligible(model: Model, args: SdpArgs, subopt) -> bool:
    """single-pass, empty subopt at pass time, device-expressible model
    (the passes run exactly once per comparison in single-pass mode, so
    a non-empty SubOpt can never reach them; guard anyway)."""
    if not args.single_pass:
        return False
    if subopt is not None and getattr(subopt, "points", None):
        return False
    return sdp_device.supported(model)


class HybridSDPPair:
    """Drop-in replacement for SDPPair.next_path on the device path."""

    def __init__(self, model: Model, comparison, data, subopt,
                 args: Optional[SdpArgs] = None,
                 device_out=None, plan=None, gpair=None):
        self.model = model
        self.comparison = comparison
        self.data = data
        self.subopt = subopt
        self.args = args or SdpArgs()
        # the global pair provides seeds, grids and the fallback path
        self.gpair = gpair if gpair is not None else SDPPair(
            model, comparison, data, subopt, self.args)
        self.plan = plan
        self.device_out = device_out
        self._locus_scores = None
        self._resolved: dict[int, SDPPair] = {}
        self._order: list = None     # [(score, seed_global_ix, locus)]
        self._pos = 0
        self._ran = False

    # -- device pass ---------------------------------------------------

    def _run_device(self):
        pair = self.gpair
        # the device scan's query/joint-span thaw only enforces the
        # q-window upper bound when it can never bind (max_query >=
        # query length); narrower windows go to the host path
        if any(sp.max_target > 0
               and 0 < sp.max_query < pair.region.query_length
               for sp in self.model.spans):
            observe.count_fallback(
                "sdp device->host: narrow query-span window")
            raise HybridFallback()
        if not pair.seeds:
            self._locus_scores = np.empty(0, np.int64)
            self.plan = sdp_bands.BandPlan([], -1, np.empty(0, np.int64),
                                           np.empty(0, np.int32),
                                           np.empty(0, np.int64), [],
                                           np.empty(0, np.int32))
            return
        if self.plan is None or self.device_out is None:
            plan = make_plan(self.model, pair)
            if not device_worthwhile(
                    plan, pair.region.query_length,
                    rows_ok=rows_usable(self.model, pair, plan)):
                observe.count_fallback(
                    "sdp device->host: below device size floor")
                raise HybridFallback()
            out = run_device(self.model, pair, plan)
            self.plan, self.device_out = plan, out
        out = self.device_out
        if out["live"] or out["xband"] or out.get("unconverged", False):
            observe.count_fallback(
                "sdp device->host: band edge liveness" if out["live"]
                else ("sdp device->host: cross-locus thaw"
                      if out["xband"]
                      else "sdp device->host: row fixpoint unconverged"))
            raise HybridFallback()
        self._locus_scores = np.asarray(
            out["band_end"][:len(self.plan.loci)], np.int64)

    # -- lazy locus resolution ------------------------------------------

    def _resolve(self, lx: int) -> SDPPair:
        bp = self._resolved.get(lx)
        if bp is not None:
            return bp
        lc = self.plan.loci[lx]
        pair = self.gpair
        seeds = pair.seeds[lc.seed_lo:lc.seed_hi]
        region = Region(0, lc.t0, pair.region.query_length,
                        lc.t1 - lc.t0)
        bp = SDPPair(self.model, self.comparison, self.data,
                     self.subopt, self.args, region=region,
                     seeds_override=[(s.q_cobs, s.t_cobs, s.hsp_score,
                                      s.hsp) for s in seeds])
        bp._find_starts()
        bp._find_ends()
        best = max((s.max_end.score for s in bp.seeds), default=NEG)
        if best != int(self._locus_scores[lx]):
            observe.count_fallback(
                "sdp device->host: locus score mismatch "
                f"({best} != {int(self._locus_scores[lx])})")
            raise HybridFallback()
        self._resolved[lx] = bp
        return bp

    def _locus_of_seed(self, global_ix: int) -> int:
        for lx, lc in enumerate(self.plan.loci):
            if lc.seed_lo <= global_ix < lc.seed_hi:
                return lx
        raise IndexError(global_ix)

    def next_path(self, threshold: int) -> Optional[Alignment]:
        """(ref: SDP_Pair_next_path single-pass walk, sdp.c:743-814)."""
        if not self._ran:
            self._run_device()
            self._ran = True
            self._emitted: set = set()
        plan = self.plan
        while True:
            # resolve every locus that could still top the stream
            # (device locus score >= best unemitted resolved seed and
            # >= threshold)
            best_seed = None   # (score, global_ix, locus SDPPair, seed)
            for lx, bp in self._resolved.items():
                lc = plan.loci[lx]
                for k, s in enumerate(bp.seeds):
                    gix = lc.seed_lo + k
                    if gix in self._emitted:
                        continue
                    key = (-s.max_end.score, gix)
                    if best_seed is None or key < best_seed[0]:
                        best_seed = (key, gix, bp, s)
            need = None
            for lx in range(len(plan.loci)):
                if lx in self._resolved:
                    continue
                sc = int(self._locus_scores[lx])
                if sc < threshold:
                    continue
                if best_seed is None or sc >= -best_seed[0][0]:
                    if need is None or sc > int(self._locus_scores[need]):
                        need = lx
            if need is not None:
                self._resolve(need)
                continue
            if best_seed is None:
                return None
            _key, gix, bp, seed = best_seed
            if seed.max_end.score < threshold:
                # ordered walk stops at the first below-threshold seed
                # (ref: sdp.c:796-800)
                return None
            self._emitted.add(gix)
            alignment = bp._find_path(seed)
            alignment = _shift_alignment(alignment, bp.region)
            if self.gpair._overlaps(alignment):
                continue
            return alignment


def _shift_alignment(a: Alignment, region: Region) -> Alignment:
    """Band-local alignment -> absolute coordinates."""
    if region.target_start == 0 and region.query_start == 0:
        return a
    shifted = Alignment(
        a.model,
        Region(a.region.query_start + region.query_start,
               a.region.target_start + region.target_start,
               a.region.query_length, a.region.target_length),
        a.score)
    shifted.ops = a.ops
    return shifted


def make_plan(model: Model, pair: SDPPair) -> sdp_bands.BandPlan:
    extents = [s.t_extent for s in pair.seeds]
    sw = max((sp.max_target for sp in model.spans), default=0)
    return sdp_bands.plan_bands(
        extents, pair.region.query_length, pair.region.target_length,
        margin=BAND_MARGIN,
        span_window=sw + 2 * BAND_MARGIN)


# Gates for the DEFAULT (non-forced) device routing.  Their values were
# set on an earlier accelerator reached over a network link, where each
# device round trip cost a large fixed latency; they have not yet been
# re-measured on the GPU (ROADMAP A5: that needs bench cells on both
# sides of each gate).
#
# below this compressed width the host native scheduler finishes in
# milliseconds and a first-time compile could never amortize; small
# comparisons only take the device path when the user forces it
# (EXONERATE_TPU_SDP=device)
DEVICE_MIN_W = 16384
# ... and below this many band cells (Q x W) the host scheduler's
# sparse-live-cell walk beats the device call's fixed dispatch and
# fetch cost even at genome-scale W (a 149 aa protein2genome query
# compresses to W<=46k but only ~7M cells)
DEVICE_MIN_CELLS = 16_000_000
# ... and below this query length the anti-diagonal band scan is
# shape-starved regardless of total cells: its step count is W+Q+1
# (driven by the huge band width) while each step only fills Q lanes.
# A row-scan recurrence (steps ∝ Q, vectors along W) is the device
# shape for these (sdp_rows.py, opt-in)
DEVICE_MIN_Q = 512


def device_worthwhile(plan, query_length: int = None,
                      rows_ok: bool = False) -> bool:
    """Size/shape gate for the DEFAULT (non-forced) device routing:
    tiny comparisons and lane-starved shapes stay on the host
    scheduler.  `rows_ok` lifts the short-query gate: the q-major
    row-scan engine (sdp_rows.py) is exactly the device shape the
    anti-diagonal scan is starved on (BASELINE.md)."""
    import os
    if os.environ.get("EXONERATE_TPU_SDP", "") == "device":
        return True
    if plan is None or plan.W < DEVICE_MIN_W:
        return False
    if query_length is not None:
        if (query_length + 1) * (plan.W + 1) < DEVICE_MIN_CELLS:
            return False
        if query_length < DEVICE_MIN_Q and not rows_ok:
            return False
    return True


def rows_usable(model: Model, pair: SDPPair, plan=None) -> bool:
    """Route through the q-major row-scan engine (sdp_rows.py)?
    OPT-IN ONLY (EXONERATE_TPU_SDP_ROWS=1 or =all): the engine is
    byte-parity-proven (differential suite + CLI goldens) but was
    measured memory-traffic-bound on the earlier accelerator — the
    exact scheduler semantics cost ~400-2000 vector passes over the
    band per row, against the ~50 of a relaxed cost skeleton — and far
    slower than the sparse host walk on the short-query protein2genome
    shape (BASELINE.md).  Not yet measured on the GPU."""
    import os
    env = os.environ.get("EXONERATE_TPU_SDP_ROWS", "")
    if env not in ("1", "all"):
        return False
    from . import sdp_rows
    if not sdp_rows.supported(model):
        return False
    try:
        sdp_rows.chain_ext_values(model, pair)
    except sdp_rows.RowUnsupported:
        return False
    return True


def _rows_preferred(model: Model, pair: SDPPair, plan) -> bool:
    """Among the device tiers, pick the row scan only when forced (see
    rows_usable: the measured traffic wall keeps it off by default)."""
    return rows_usable(model, pair, plan)


def run_rows_batch(model: Model, jobs: list) -> list[dict]:
    """Batched q-major row-scan passes: one vmapped call per
    (shape, kinds, exts) bucket (mirrors the XLA-scan bucketing in
    run_device_batch)."""
    import jax
    from .wavefront import _bucket
    from . import sdp_rows
    out: list = [None] * len(jobs)
    shape_max: dict = {}
    for ix, (pair, plan) in enumerate(jobs):
        gkey = (pair.use_boundary, pair.args.dropoff)
        cur = shape_max.get(gkey, (0, 0, 0))
        shape_max[gkey] = (max(cur[0], pair.region.query_length),
                           max(cur[1], len(pair.seeds)),
                           max(cur[2], len(plan.loci) + 1))
    buckets: dict = {}
    for ix, (pair, plan) in enumerate(jobs):
        gkey = (pair.use_boundary, pair.args.dropoff)
        mq, ms, mg = shape_max[gkey]
        Qp = _bucket(mq)
        Wp = _pow2(max(plan.W, 1024))
        n_seed_pad, n_seg_pad = _pow2(ms), _pow2(mg)
        inputs, kinds = sdp_device.prepare_inputs(model, pair, plan,
                                                  pad_to=(Qp, Wp))
        inputs.update(sdp_device.prepare_seeds(pair, plan, n_seed_pad))
        exts = sdp_rows.chain_ext_values(model, pair)
        key = (Qp, Wp, kinds, pair.use_boundary, n_seed_pad, n_seg_pad,
               pair.args.dropoff, exts)
        buckets.setdefault(key, []).append((ix, inputs))
    for (Qp, Wp, kinds, ub, nsp, ngp, dropoff, exts), items \
            in buckets.items():
        fn = sdp_rows.get_fn(model, Qp, Wp, kinds, ub, nsp, ngp,
                             dropoff, exts, batched=len(items) > 1)
        observe.count_engine("sdp-rows", len(items))
        if len(items) > 1:
            stacked = jax.tree_util.tree_map(
                lambda *xs: np.stack(xs), *[inp for _, inp in items])
            res = jax.tree_util.tree_map(np.asarray,
                                         fn(jax.device_put(stacked)))
            for b, (ix, _) in enumerate(items):
                out[ix] = jax.tree_util.tree_map(lambda a: a[b], res)
        else:
            ix, inputs = items[0]
            out[ix] = jax.tree_util.tree_map(np.asarray, fn(inputs))
    return out


# above this many compressed diagonals the XLA lax.scan expression is
# slower than the host native scheduler for a lone comparison (per-step
# dispatch overhead): fall straight back to the host global path
SCAN_DIAG_CAP = 8192


def run_device(model: Model, pair: SDPPair,
               plan: sdp_bands.BandPlan) -> dict:
    """Single-comparison device call (the pooled path batches many)."""
    from .wavefront import _bucket
    if _rows_preferred(model, pair, plan):
        return run_rows_batch(model, [(pair, plan)])[0]
    Q = pair.region.query_length
    if Q + plan.W + 1 > SCAN_DIAG_CAP:
        observe.count_fallback(
            "sdp device->host: scan too long for a lone comparison")
        raise HybridFallback()
    Qp, Wp = _bucket(Q), _bucket(plan.W)
    n_seed_pad = _pow2(len(pair.seeds))
    n_seg_pad = _pow2(len(plan.loci) + 1)
    inputs, kinds = sdp_device.prepare_inputs(model, pair, plan,
                                              pad_to=(Qp, Wp))
    inputs.update(sdp_device.prepare_seeds(pair, plan, n_seed_pad))
    fn = sdp_device.get_fn(model, Qp, Wp, kinds, pair.use_boundary,
                           n_seed_pad, n_seg_pad, pair.args.dropoff)
    observe.count_engine("sdp-device")
    out = fn(inputs)
    return {k: np.asarray(v) for k, v in out.items()}


def _pow2(n: int) -> int:
    p = 8
    while p < n:
        p <<= 1
    return p


def run_device_batch(model: Model, jobs: list) -> list[dict]:
    """Batched device pass over many comparisons' (pair, plan) jobs —
    one vmapped call per (shape, kinds) bucket, so a whole scan's SDP
    passes cost a handful of device dispatches instead of one per
    comparison (the batched replacement for the reference's
    per-comparison thread pool, SURVEY.md §2.13)."""
    import jax
    from .wavefront import _bucket
    out: list = [None] * len(jobs)
    # row-scan tier first (opt-in, see rows_usable)
    rows_jobs = [ix for ix, (pair, plan) in enumerate(jobs)
                 if _rows_preferred(model, pair, plan)]
    if rows_jobs:
        rres = run_rows_batch(model, [jobs[ix] for ix in rows_jobs])
        for ix, r in zip(rows_jobs, rres):
            out[ix] = r
    remap = [ix for ix in range(len(jobs)) if ix not in set(rows_jobs)]
    jobs = [jobs[ix] for ix in remap]
    # coarse pow2 rungs on the compressed width keep the compiled-shape
    # count small (2-3 per scan) without the 2x+ padded-cell waste of a
    # single max-shape bucket; Q/seed/segment pads take the group max
    shape_max: dict = {}
    for ix, (pair, plan) in enumerate(jobs):
        gkey = (pair.use_boundary, pair.args.dropoff)
        cur = shape_max.get(gkey, (0, 0, 0))
        shape_max[gkey] = (max(cur[0], pair.region.query_length),
                           max(cur[1], len(pair.seeds)),
                           max(cur[2], len(plan.loci) + 1))
    buckets: dict = {}
    for ix, (pair, plan) in enumerate(jobs):
        gkey = (pair.use_boundary, pair.args.dropoff)
        mq, ms, mg = shape_max[gkey]
        Qp = _bucket(mq)
        Wp = _pow2(max(plan.W, 1024))
        n_seed_pad, n_seg_pad = _pow2(ms), _pow2(mg)
        inputs, kinds = sdp_device.prepare_inputs(model, pair, plan,
                                                  pad_to=(Qp, Wp))
        inputs.update(sdp_device.prepare_seeds(pair, plan, n_seed_pad))
        key = (Qp, Wp, kinds, pair.use_boundary, n_seed_pad, n_seg_pad,
               pair.args.dropoff)
        buckets.setdefault(key, []).append((ix, inputs))
    for (Qp, Wp, kinds, ub, nsp, ngp, dropoff), items in buckets.items():
        fn = sdp_device.get_fn(model, Qp, Wp, kinds, ub, nsp, ngp,
                               dropoff, batched=True)
        stacked = jax.tree_util.tree_map(
            lambda *xs: np.stack(xs), *[inp for _, inp in items])
        observe.count_engine("sdp-device", len(items))
        res = jax.tree_util.tree_map(np.asarray,
                                     fn(jax.device_put(stacked)))
        for b, (ix, _) in enumerate(items):
            out[remap[ix]] = jax.tree_util.tree_map(lambda a: a[b], res)
    return out
