"""GAM: the gapped alignment manager / result machinery.

Equivalent of the reference GAM (ref: src/hub/gam.{h,c}): owns
the model and engines, converts comparisons into alignments (ungapped
shortcut, heuristic DP, exhaustive suboptimal enumeration), applies
score/percent/bestn thresholds and dispatches every enabled output format.
The reference's tmpfile-backed bestn machinery (gam.c:172-219) is replaced
by an in-memory store with identical final-set semantics: an alignment is
reported iff fewer than best_n strictly better alignments exist for the
query, ranked 1..N in descending score order.
"""
from __future__ import annotations

import enum
import sys
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..align.alignment import Alignment, AlignmentArgs
from ..align import formats
from ..engine.region import Region
from ..engine import reference as ref_engine
from ..model.ir import Label, Model
from ..model.registry import ModelType, translate_both, has_genomic_target
from ..model.data import AlignData
from ..seeds.hsp import Comparison, HSP, HspSet
from ..seqio import Sequence


class Refinement(enum.Enum):
    NONE = "none"
    FULL = "full"
    REGION = "region"


@dataclass
class GamArgs:
    """(ref: GAM_ArgumentSet, gam.c:93-155)."""
    model_type: ModelType = ModelType.UNGAPPED
    threshold: int = 100
    percent_threshold: float = 0.0
    show_alignment: bool = True
    show_sugar: bool = False
    show_cigar: bool = False
    show_vulgar: bool = True
    show_query_gff: bool = False
    show_target_gff: bool = False
    ryo: Optional[str] = None
    best_n: int = 0
    use_subopt: bool = True
    use_gapped_extension: bool = True
    refinement: Refinement = Refinement.NONE
    refinement_boundary: int = 32
    # SDP options (ref: SDP_ArgumentSet, sdp.c:28-32)
    extension_threshold: int = 50
    single_pass: bool = True
    # Heuristic/BSDP/SAR options (ref: heuristic.c:78-96, bsdp.c:25-26,
    # sar.c:26-27)
    terminal_range_internal: int = 12
    terminal_range_external: int = 12
    join_range_internal: int = 12
    join_range_external: int = 12
    span_range_internal: int = 12
    span_range_external: int = 12
    join_filter: int = 0
    hsp_quality: float = 0.0


@dataclass
class _Stored:
    score: int
    text: str
    order: int


class GAM:
    """(ref: GAM, gam.h:91-154)."""

    def __init__(self, model: Model, gas: GamArgs,
                 make_data, align_args: Optional[AlignmentArgs] = None,
                 out=None, engine: str = "reference"):
        self.model = model
        self.gas = gas
        self.make_data = make_data      # (query, target) -> AlignData
        self.align_args = align_args or AlignmentArgs()
        self.out = out or sys.stdout
        self.engine = engine
        # query_id -> list of stored results (bestn mode)
        self.bestn_store: dict[str, list[_Stored]] = {}
        self._order = 0
        # multi-host driver: suppress the local bestn replay so stores
        # can merge across processes first (parallel/multihost.py)
        self.defer_report = False
        self.geneseed_threshold = 0
        # multi-device pair dispatch (--cores N): comparisons round-robin
        # across local devices — the functional replacement for the
        # reference's disabled-for-races thread pool (SURVEY.md §2.13)
        self.devices: list = []
        self._dev_rr = 0

    # -- thresholds (ref: GAM_get_query_threshold, gam.c:677-705) ---------

    # The reference's advance-3 self-score loop overruns the final
    # window when len % 3 != 0 (gam.c:477-478 steps j by advance while
    # j < len, reading seq[len]/seq[len+1]); the terminator translates
    # to '-' and Submat_lookup('-','-') reads past the packed matrix —
    # a huge heap-dependent garbage term (observed 1,952,539,695 with
    # blosum62, 1,836,277,605 with pam250 in the shim build).  The
    # observable contract: the per-query threshold explodes, the gint
    # *= gfloat conversion overflows to INT_MIN for any realistic
    # --percent, and the threshold falls back to --score.  We add one
    # fixed huge term to reproduce that contract (the exact constant
    # only matters for --percent <= ~1.1, where both sides already
    # report nothing).
    _SELF_OVERRUN_GARBAGE = 1952539695

    def _percent_matches(self, data: AlignData) -> list:
        """Unique matches of the model's MATCH transitions in first-
        encounter order (ref: GAM_build_match_list, gam.c:369-391),
        resolved through AlignData so user submats apply."""
        types = []
        for t in self.model.transitions:
            if t.label == Label.MATCH and t.label_data is not None:
                mt = getattr(t.label_data, "type", None)
                if mt is not None and mt not in types:
                    types.append(mt)
        if not types:
            return [data.match()]
        return [data.match(mt) for mt in types]

    def query_threshold(self, query: Sequence, data: AlignData) -> int:
        if self.gas.best_n:
            stored = self.bestn_store.get(query.id)
            if stored and len(stored) >= self.gas.best_n:
                return min(s.score for s in stored)
        if self.gas.percent_threshold:
            import math
            th = 0
            for match in self._percent_matches(data):
                t = match.self_score(query)
                if match.advance_query == 3 and len(query) % 3:
                    t += self._SELF_OVERRUN_GARBAGE
                th = max(th, t)
            # gint *= gfloat: float32 product, out-of-range conversion
            # lands on INT_MIN (x86 cvttss2si); then C integer division
            # truncates toward zero (ref: gam.c:482-485)
            v = float(np.float32(np.float32(th)
                                 * np.float32(self.gas.percent_threshold)))
            th = (-(1 << 31) if not (-(2.0 ** 31) <= v < 2.0 ** 31)
                  else int(v))
            th = math.trunc(th / 100)
            if th < self.gas.threshold:
                th = self.gas.threshold
            return th
        return self.gas.threshold

    # -- result creation ---------------------------------------------------

    def result_ungapped(self, comparison: Comparison
                        ) -> list[tuple[Alignment, AlignData]]:
        """(ref: GAM_Result_ungapped_create, gam.c:736-763)."""
        from ..engine.subopt import SubOpt
        if not comparison.has_hsps:
            return []
        data = self.make_data(comparison.query, comparison.target)
        subopt = (SubOpt() if self.gas.refinement != Refinement.NONE
                  else None)
        out = []
        for hspset in comparison.hspsets():
            hspset.filter_ungapped()
            threshold = self.query_threshold(comparison.query, data)
            for hsp in hspset.hsps:
                if hsp.score >= threshold:
                    alignment = self._hsp_alignment(hspset, hsp)
                    alignment = self._refine(alignment, data, subopt)
                    out.append((alignment, data))
                    if subopt is not None:
                        subopt.add_alignment(alignment)
        out.sort(key=lambda ad: -ad[0].score)
        return out

    def _refine(self, alignment: Alignment, data: AlignData,
                subopt) -> Alignment:
        """(ref: GAM_Result_refine_alignment, gam.c:605-655): re-DP over
        the full rectangle or the boundary-padded alignment region; keep
        the refined alignment only if it scores at least as well."""
        from ..engine import optimal
        if self.gas.refinement == Refinement.NONE:
            return alignment
        q, t = data.query, data.target
        if self.gas.refinement == Refinement.FULL:
            region = Region(0, 0, len(q), len(t))
        else:
            b = self.gas.refinement_boundary
            qs = max(0, alignment.region.query_start - b)
            ts = max(0, alignment.region.target_start - b)
            region = Region(
                qs, ts,
                min(len(q), alignment.region.query_end + b) - qs,
                min(len(t), alignment.region.target_end + b) - ts)
        refined = optimal.find_path(self.model, region, data, subopt)
        if refined is not None and refined.score >= alignment.score:
            return refined
        return alignment

    def _hsp_alignment(self, hspset: HspSet, hsp: HSP) -> Alignment:
        """(ref: Ungapped_Alignment_create, ungapped.c:168-198)."""
        model = self.model
        start2match = match2match = match2end = None
        for t in model.transitions:
            if t.input is model.start_state.state:
                start2match = t
            elif t.output is model.end_state.state:
                match2end = t
            else:
                match2match = t
        region = Region(hsp.query_start, hsp.target_start,
                        hsp.query_end(hspset.qadv) - hsp.query_start,
                        hsp.target_end(hspset.tadv) - hsp.target_start)
        a = Alignment(model, region, hsp.score)
        a.add(start2match, 1)
        a.add(match2match, hsp.length)
        a.add(match2end, 1)
        return a

    def result_heuristic(self, comparison: Comparison
                         ) -> list[tuple[Alignment, AlignData]]:
        """Heuristic gapped path (ref: GAM_Result_heuristic_create,
        gam.c:1107-1180): seeded DP with reference-exact semantics
        (ref: GAM_Result_SDP_create, gam.c:852-888).  The locus-region
        heuristic (pre-SDP design, not byte-parity) remains available
        via EXONERATE_TPU_HEURISTIC=locus."""
        import os
        from ..engine.subopt import SubOpt
        from ..engine.sdp import SDPPair, SdpArgs
        if not comparison.has_hsps:
            return []
        if self.geneseed_threshold:
            # (ref: GAM_Result_heuristic_create, gam.c:1112-1121):
            # geneseed raises the report threshold too, so low-scoring
            # subopt alignments never emit
            if self.gas.threshold < self.geneseed_threshold:
                self.gas.threshold = self.geneseed_threshold
            self._geneseed_filter(comparison)
            if not comparison.has_hsps:
                return []
        query, target = comparison.query, comparison.target
        data = self.make_data(query, target)
        if not self.gas.use_gapped_extension:
            return self._result_bsdp(comparison, data)
        if os.environ.get("EXONERATE_TPU_HEURISTIC") == "locus":
            return self._result_heuristic_locus(comparison, data)
        sdp_pair = self._make_sdp_pair(comparison, data)
        try:
            return self._run_sdp_loop(sdp_pair, query, data)
        except Exception as exc:
            from ..engine.sdp_hybrid import HybridFallback
            if not isinstance(exc, HybridFallback):
                raise
            # device result unusable: redo the whole comparison on the
            # host global path (nothing was submitted yet)
            sdp_pair = SDPPair(self.model, comparison, data, SubOpt(),
                               SdpArgs(self.gas.extension_threshold,
                                       self.gas.single_pass))
            return self._run_sdp_loop(sdp_pair, query, data)

    def sdp_device_active(self) -> bool:
        """True when the default heuristic should run its SDP passes on
        the device and the model is device-expressible: by default
        whenever an accelerator is attached (device.sdp_tier), with the
        band scans batched through the XLA tier (engine/sdp_device.py).
        EXONERATE_TPU_SDP=device forces it everywhere (the CPU XLA scan
        included); =native / =python force the host engines."""
        from .. import device
        from ..engine import sdp_hybrid
        from ..engine.sdp import SdpArgs
        if device.sdp_tier() != "device":
            return False
        args = SdpArgs(self.gas.extension_threshold, self.gas.single_pass)
        return sdp_hybrid.eligible(self.model, args, None)

    def run_sdp_pool(self, comparisons: list):
        """Pooled device SDP over many deferred comparisons: all passes
        batch into a handful of vmapped device calls, then each
        comparison's result loop runs (and submits) in original order,
        so output bytes match the per-comparison path exactly."""
        from .. import observe
        from ..engine import sdp_hybrid
        from ..engine.sdp import SDPPair, SdpArgs
        from ..engine.subopt import SubOpt
        args = SdpArgs(self.gas.extension_threshold,
                       self.gas.single_pass)
        metas = []
        jobs = []
        for comp in comparisons:
            if not comp.has_hsps:
                metas.append(None)
                continue
            if self.geneseed_threshold:
                if self.gas.threshold < self.geneseed_threshold:
                    self.gas.threshold = self.geneseed_threshold
                self._geneseed_filter(comp)
                if not comp.has_hsps:
                    metas.append(None)
                    continue
            data = self.make_data(comp.query, comp.target)
            gpair = SDPPair(self.model, comp, data, SubOpt(), args)
            plan = (sdp_hybrid.make_plan(self.model, gpair)
                    if gpair.seeds else None)
            if plan is not None \
                    and not sdp_hybrid.device_worthwhile(
                        plan, gpair.region.query_length,
                        rows_ok=sdp_hybrid.rows_usable(
                            self.model, gpair, plan)):
                # tiny comparison: host scheduler directly (no device
                # dispatch, no first-time kernel compile)
                metas.append((comp, data, gpair, "host"))
                continue
            metas.append((comp, data, gpair, plan))
            if plan is not None:
                jobs.append((gpair, plan))
        # dispatch the device batch on a worker so the host-route
        # comparisons (sub-floor minus strands) overlap the kernel's
        # compute + fetch round-trips; result submission order is
        # unchanged (everything joins before submit)
        dev_fut = None
        if jobs:
            from concurrent.futures import ThreadPoolExecutor
            _dev_pool = ThreadPoolExecutor(max_workers=1)
            dev_fut = _dev_pool.submit(sdp_hybrid.run_device_batch,
                                       self.model, jobs)
            _dev_pool.shutdown(wait=False)

        # device-output slot per meta (resolved lazily inside the
        # fan-out, so host-route loops can start before the device
        # batch lands)
        job_ix = 0
        job_of_meta = {}
        for mx, meta in enumerate(metas):
            if meta is not None and meta[3] not in ("host", None):
                job_of_meta[mx] = job_ix
                job_ix += 1

        def result_loop(mx_meta):
            mx, meta = mx_meta
            if meta is None:
                return []
            comp, data, gpair, plan = meta[:4]
            if plan == "host":
                return self._run_sdp_loop(gpair, comp.query, data)
            out = (dev_fut.result()[job_of_meta[mx]]
                   if mx in job_of_meta else None)
            hp = sdp_hybrid.HybridSDPPair(
                self.model, comp, data, gpair.subopt, args,
                device_out=out, plan=plan, gpair=gpair)
            try:
                return self._run_sdp_loop(hp, comp.query, data)
            except sdp_hybrid.HybridFallback:
                pair = SDPPair(self.model, comp, data, SubOpt(), args)
                return self._run_sdp_loop(pair, comp.query, data)

        # host-route metas first in the worker queue: they overlap the
        # in-flight device batch; submission order is restored below
        metas = list(enumerate(metas))
        order = sorted(
            range(len(metas)),
            key=lambda mx: 0 if (metas[mx][1] is not None
                                 and metas[mx][1][3] == "host") else 1)
        # the per-comparison walks are independent: host locus
        # resolutions (the warm scan's largest remaining cost) run
        # through ctypes calls that release the GIL, so a small thread
        # pool overlaps them; submission stays in original order so
        # output bytes are unchanged (the safe counterpart of the
        # reference's disabled -c threads, ref: README.md:24-25,
        # analysis.c:120-128)
        import os as _os
        n_workers = int(_os.environ.get(
            "EXONERATE_TPU_RESOLVE_THREADS",
            str(min(4, _os.cpu_count() or 1))))
        if n_workers > 1 and sum(m is not None for _, m in metas) > 1:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=n_workers) as ex:
                ordered = list(ex.map(result_loop,
                                      [metas[mx] for mx in order]))
            all_results = [None] * len(metas)
            for mx, res in zip(order, ordered):
                all_results[mx] = res
        else:
            all_results = [result_loop(m) for m in metas]
        for results in all_results:
            self.submit(results)

    def _geneseed_filter(self, comparison):
        """HSP reachability filter (ref: GAM_Result_geneseed_filter,
        gam.c:1044-1105): starting from every geneseed HSP (score >=
        geneseed threshold), flood rectangle searches over the HSP
        cobs points forward and backward; an HSP survives if marked in
        EITHER direction.  Search ranges grow with the visited HSP's
        extent past its cobs plus the global max-cobs HSP's leading
        extent, padded by the model's span windows (gam.c:444-450).
        The mark set is search-order independent, so a flat worklist
        replaces the reference's recursive RangeTree walk; the tree's
        first-point-wins dedup (same-cobs-point HSPs are unreachable
        through the tree) is mirrored."""
        import numpy as np
        entries = []                    # (hspset, hsp, q_cobs, t_cobs)
        points: dict = {}
        max_cobs = None
        for hs in comparison.hspsets():
            for h in hs.hsps:
                qc = h.query_start + h.cobs * hs.qadv
                tc = h.target_start + h.cobs * hs.tadv
                hid = len(entries)
                entries.append((hs, h, qc, tc))
                if (qc, tc) not in points:
                    points[(qc, tc)] = hid
                if max_cobs is None \
                        or entries[max_cobs][1].cobs < h.cobs:
                    max_cobs = hid
        if not entries:
            return
        mq = max((sp.max_query for sp in self.model.spans), default=0)
        mt = max((sp.max_target for sp in self.model.spans), default=0)
        _mh_hs, mh, mh_qc, mh_tc = entries[max_cobs]
        mq_off = mh_qc - mh.query_start
        mt_off = mh_tc - mh.target_start
        tree_ids = np.array(sorted(points.values()), np.int64)
        tqc = np.array([entries[i][2] for i in tree_ids], np.int64)
        ttc = np.array([entries[i][3] for i in tree_ids], np.int64)
        fwd = [False] * len(entries)
        rev = [False] * len(entries)
        work = [(i, d)
                for i, (hs, h, _q, _t) in enumerate(entries)
                if h.score >= self.geneseed_threshold
                for d in (True, False)]
        while work:
            hid, is_fwd = work.pop()
            mark = fwd if is_fwd else rev
            if mark[hid]:
                continue
            mark[hid] = True
            hs, h, qc, tc = entries[hid]
            qr = mq + ((h.query_start + h.length * hs.qadv - qc)
                       + mq_off) * 2
            tr = mt + ((h.target_start + h.length * hs.tadv - tc)
                       + mt_off) * 2
            if is_fwd:
                sel = ((tqc >= qc) & (tqc < qc + qr)
                       & (ttc >= tc) & (ttc < tc + tr))
            else:
                sel = ((tqc >= qc - qr) & (tqc < qc)
                       & (ttc >= tc - tr) & (ttc < tc))
            for j in tree_ids[np.nonzero(sel)[0]]:
                if not (fwd if is_fwd else rev)[j]:
                    work.append((int(j), is_fwd))
        hid = 0
        for hs in comparison.hspsets():
            keep = []
            for h in hs.hsps:
                if fwd[hid] or rev[hid]:
                    keep.append(h)
                hid += 1
            hs.hsps = keep

    def _make_sdp_pair(self, comparison, data):
        """Default SDP executor: the device-hybrid pair when the device
        tier serves this model (see sdp_device_active), else the host
        pair (native C++ scheduler)."""
        import os
        from ..engine.subopt import SubOpt
        from ..engine.sdp import SDPPair, SdpArgs
        args = SdpArgs(self.gas.extension_threshold,
                       self.gas.single_pass)
        if self.sdp_device_active():
            from ..engine import sdp_hybrid
            return sdp_hybrid.HybridSDPPair(
                self.model, comparison, data, SubOpt(), args)
        if os.environ.get("EXONERATE_TPU_SDP", "") == "device":
            from .. import observe
            observe.count_fallback(
                "sdp device->host: model unsupported on device")
        return SDPPair(self.model, comparison, data, SubOpt(), args)

    def _run_sdp_loop(self, sdp_pair, query, data):
        out: list[tuple[Alignment, AlignData]] = []
        while True:
            threshold = self.query_threshold(query, data)
            alignment = sdp_pair.next_path(threshold)
            if alignment is None:
                break
            if self.gas.refinement != Refinement.NONE:
                refined = self._refine(alignment, data,
                                       sdp_pair.subopt)
                if refined is not None and \
                        refined.score >= alignment.score:
                    alignment = refined
            out.append((alignment, data))
            sdp_pair.subopt.add_alignment(alignment)
            # (ref: GAM_Result_is_full, gam.c:779-793)
            if self.gas.best_n and len(out) >= self.gas.best_n \
                    and len(out) > 1 \
                    and out[-2][0].score != out[-1][0].score:
                break
            if not self.gas.use_subopt:
                break
        return out

    def _result_heuristic_locus(self, comparison: Comparison,
                                data: AlignData
                                ) -> list[tuple[Alignment, AlignData]]:
        """Locus-region heuristic: exhaustive Waterman-Eggert over each
        clustered locus (optimal.find_path); not byte-parity with the
        reference SDP (whether it stays is open in ROADMAP.md)."""
        from ..engine.subopt import SubOpt
        from ..engine import optimal
        from .heuristic import cluster_hsps, cluster_regions
        query, target = comparison.query, comparison.target
        genomic = has_genomic_target(self.gas.model_type)
        t_join = (data.intron.max_intron if genomic
                  else max(data.ner.max_ner, 10000))
        clusters = cluster_hsps(comparison, t_join, 10000)
        # geneseed gating (ref: GAM geneseed reachability filter,
        # gam.c:1044-1105): only loci anchored by a strong seed survive
        if self.geneseed_threshold:
            clusters = [c for c in clusters
                        if c.score >= self.geneseed_threshold]
        regions = cluster_regions(comparison, clusters,
                                  target_margin=1000, query_margin=1000)
        threshold = self.query_threshold(query, data)
        if self.model.is_local:
            threshold = max(threshold, 1)
        subopt = SubOpt() if self.gas.use_subopt else None
        out = []
        for region in regions:
            device = None
            if self.devices:
                device = self.devices[self._dev_rr % len(self.devices)]
                self._dev_rr += 1
            while True:
                alignment = optimal.find_path(self.model, region, data,
                                              subopt=subopt, device=device)
                if alignment is None or alignment.score < threshold:
                    break
                out.append((alignment, data))
                if subopt is None or not self.model.is_local:
                    break
                subopt.add_alignment(alignment)
                if self.gas.best_n and len(out) >= max(
                        self.gas.best_n * 4, 16):
                    break
        out.sort(key=lambda ad: -ad[0].score)
        return out

    def _find_portal(self, hspset):
        """First portal whose advances match the HSP class
        (ref: GAM_Pair_find_portal, gam.c:560-581)."""
        for portal in self.model.portals:
            if portal.transitions \
                    and portal.transitions[0].advance_query == hspset.qadv \
                    and portal.transitions[0].advance_target == hspset.tadv:
                return portal
        raise ValueError("No compatible portal found for hspset")

    def _get_heuristic(self, data: AlignData):
        """Per-model Heuristic (derived sub-models + bound matrices),
        built once like the reference's GAM-owned Heuristic
        (ref: gam.c:392-456)."""
        import threading
        if getattr(self, "_heuristic_lock", None) is None:
            self._heuristic_lock = threading.Lock()
        with self._heuristic_lock:
            return self._get_heuristic_locked(data)

    def _get_heuristic_locked(self, data: AlignData):
        if getattr(self, "_heuristic", None) is None:
            from .bsdp import Heuristic, HeuristicArgs
            has = HeuristicArgs(
                terminal_range_internal=self.gas.terminal_range_internal,
                terminal_range_external=self.gas.terminal_range_external,
                join_range_internal=self.gas.join_range_internal,
                join_range_external=self.gas.join_range_external,
                span_range_internal=self.gas.span_range_internal,
                span_range_external=self.gas.span_range_external,
                join_filter=self.gas.join_filter,
                hsp_quality=self.gas.hsp_quality)
            self._heuristic = Heuristic(self.model, has, data)
        return self._heuristic

    def _result_bsdp(self, comparison: Comparison, data: AlignData
                     ) -> list[tuple[Alignment, AlignData]]:
        """--gappedextension no: the BSDP HSP-graph heuristic
        (ref: GAM_Result_BSDP_create, gam.c:797-850)."""
        from .bsdp import HPair
        from ..engine.subopt import SubOpt
        query, target = comparison.query, comparison.target
        heuristic = self._get_heuristic(data)
        subopt = SubOpt()
        hpair = HPair(heuristic, subopt, len(query), len(target), data)
        for hspset in comparison.hspsets():
            hpair.add_hspset(self._find_portal(hspset), hspset)
        threshold = self.query_threshold(query, data)
        hpair.finalise(threshold)
        out: list[tuple[Alignment, AlignData]] = []
        while True:
            threshold = self.query_threshold(query, data)
            alignment = hpair.next_path(threshold)
            if alignment is None:
                break
            if self.gas.refinement != Refinement.NONE:
                refined = self._refine(alignment, data, subopt)
                if refined is not None and \
                        refined.score >= alignment.score:
                    alignment = refined
            out.append((alignment, data))
            subopt.add_alignment(alignment)
            # (ref: GAM_Result_is_full, gam.c:779-793)
            if self.gas.best_n and len(out) >= self.gas.best_n \
                    and len(out) > 1 \
                    and out[-2][0].score != out[-1][0].score:
                break
            if not self.gas.use_subopt:
                break
        return out

    def result_exhaustive(self, query: Sequence, target: Sequence
                          ) -> list[tuple[Alignment, AlignData]]:
        """Exhaustive suboptimal enumeration (ref: OPair +
        GAM_Result_exhaustive_create, gam.c:1140-1180)."""
        from ..engine.subopt import SubOpt
        from ..engine import optimal
        data = self.make_data(query, target)
        region = Region(0, 0, len(query), len(target))
        threshold = max(self.query_threshold(query, data), 1) \
            if self.model.is_local else self.query_threshold(query, data)
        subopt = SubOpt() if self.gas.use_subopt else None
        out = []
        while True:
            alignment = optimal.find_path(self.model, region, data,
                                          subopt=subopt)
            if alignment is None or alignment.score < threshold:
                break
            out.append((alignment, data))
            if subopt is None or not self.model.is_local:
                break
            subopt.add_alignment(alignment)
            if self.gas.best_n and len(out) >= max(self.gas.best_n * 4, 16):
                break
        return out

    # -- submission (ref: GAM_Result_submit, gam.c:1252-1275) -------------

    def submit(self, results: list[tuple[Alignment, AlignData]]):
        if not results:
            return
        query = None
        # result_id is 1-based within this result batch
        # (ref: GAM_Result_display, gam.c:1240-1251)
        if self.gas.best_n:
            for i, (alignment, data) in enumerate(results, 1):
                self._bestn_submit(alignment, data, i)
        else:
            for i, (alignment, data) in enumerate(results, 1):
                self.out.write(self._render(alignment, data, rank=-1,
                                            result_id=i))

    def _bestn_submit(self, alignment: Alignment, data: AlignData,
                      result_id: int):
        qid = data.query.id
        store = self.bestn_store.setdefault(qid, [])
        n = self.gas.best_n
        better = sum(1 for s in store if s.score > alignment.score)
        if better >= n:
            return
        self._order += 1
        # bestn tmpfile path renders with result_id=0 (ref: gam.c:178-181:
        # GAM_display_alignment(..., 0, -1, ...)), so GFF gene_id /
        # alignment_id are 0 under --bestn
        store.append(_Stored(alignment.score,
                             self._render(alignment, data, rank=None,
                                          result_id=0),
                             self._order))
        # evict: keep only entries with fewer than n strictly better
        scores = sorted((s.score for s in store), reverse=True)
        store[:] = [s for s in store
                    if sum(1 for sc in scores if sc > s.score) < n]

    def report(self):
        """Final bestn replay (ref: GAM_report, gam.c:550-556): per query
        in id-sorted order, descending score, ranks 1..N."""
        if not self.gas.best_n or self.defer_report:
            return
        for qid in sorted(self.bestn_store):
            store = self.bestn_store[qid]
            store.sort(key=lambda s: (-s.score, s.order))
            for rank, s in enumerate(store, 1):
                self.out.write(s.text.replace("%_EXONERATE_BESTN_RANK_%",
                                              str(rank)))

    # -- rendering (ref: GAM_display_alignment, gam.c:1210-1237) ----------

    def _render(self, alignment: Alignment, data: AlignData,
                rank, result_id: int = 0) -> str:
        gas = self.gas
        q, t = data.query, data.target
        parts = []
        if gas.show_alignment:
            parts.append(formats.display_human(alignment, q, t, data,
                                               self.align_args))
        if gas.show_sugar:
            parts.append(formats.display_sugar(alignment, q, t,
                                               self.align_args))
        if gas.show_cigar:
            parts.append(formats.display_cigar(alignment, q, t,
                                               self.align_args))
        if gas.show_vulgar:
            parts.append(formats.display_vulgar(alignment, q, t,
                                                self.align_args))
        if gas.show_query_gff or gas.show_target_gff:
            from ..align import gff
            if gas.show_query_gff:
                parts.append(gff.display_gff(alignment, q, t, data, True,
                                             False, self.align_args,
                                             result_id=result_id))
            if gas.show_target_gff:
                parts.append(gff.display_gff(
                    alignment, q, t, data, False,
                    has_genomic_target(gas.model_type), self.align_args,
                    result_id=result_id))
        if gas.ryo:
            from ..align import ryo
            parts.append(ryo.display_ryo(alignment, q, t, data, gas.ryo,
                                         rank, self.align_args))
        return "".join(parts)
