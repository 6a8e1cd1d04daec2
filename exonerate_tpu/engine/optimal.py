"""Optimal: the find-score / find-path facade.

Equivalent of the reference Optimal (ref: src/c4/optimal.{h,c}):
find_path = reduced-space FIND_REGION over the full rectangle (on the JAX
wavefront engine) followed by a traceback DP restricted to the discovered
alignment region (on the NumPy interpreter, whose per-cell cost only pays
on the small region).  This mirrors the reference's region-then-path
strategy including its checkpointed memory bound: the wavefront engine IS
the O(diagonal)-memory pass.
"""
from __future__ import annotations

from typing import Optional

from .. import device as hw
from ..align.alignment import Alignment
from ..model.ir import Model
from .region import Region
from . import reference, wavefront
from .reference import DPResult

# below this many cells the interpreter path is cheaper than a jit trace
SMALL_DP_CELLS = 40_000

# --dpmemory budget for full-traceback planes (ref: viterbi.c:32-33);
# larger DPs use checkpointed recompute (wavefront.find_path_checkpointed)
DP_MEMORY_LIMIT = 32 << 20


# native dense-DP traceback plane budget (bytes); beyond it the
# checkpointed / device engines take over.  --dpmemory raises it when
# set higher; the 256 MB floor reflects host (not DP-era) memory — the
# checkpointed recompute path still honours --dpmemory itself.
NATIVE_TB_BUDGET = 256 << 20


def _native_tb_budget() -> int:
    return max(NATIVE_TB_BUDGET, DP_MEMORY_LIMIT)


def _native_res(model: Model, region: Region, data, mode, subopt):
    """Dense C++ Viterbi (native/sdplib.cpp), or None to fall back."""
    import os
    if os.environ.get("EXONERATE_TPU_SDP") == "python":
        return None
    from . import sdp_native
    from .. import observe
    try:
        res = sdp_native.run_viterbi(model, region, data, mode, subopt)
        if res is not None:
            observe.count_engine("native")
        return res
    except AssertionError:
        raise
    except Exception as exc:
        observe.count_fallback(
            f"native->device: {type(exc).__name__} in dense Viterbi")
        return None


# without an accelerator, the native dense DP serves up to this many
# cells (larger jobs take the XLA wavefront engine on the CPU)
NATIVE_DIRECT_CELLS = 16_000_000

# with an accelerator attached, jobs above this many cells go to the
# device wavefront engine.  Carried over from the earlier accelerator,
# where the native engine (~3 M cells/s dense) beat the device's
# dispatch latency below ~1M cells; not yet re-measured on the GPU
# (ROADMAP A5)
NATIVE_ACCEL_CELLS = 1_000_000


def _prefer_native(region: Region, masked: bool = False) -> bool:
    cells = ((region.query_length + 1) * (region.target_length + 1))
    if cells <= NATIVE_ACCEL_CELLS:
        return True
    if hw.exhaustive_on_device() and not masked:
        # masked Waterman-Eggert re-runs stay native: each arrives as a
        # lone call whose masked variant would compile per shape
        return False
    return cells <= NATIVE_DIRECT_CELLS


def find_score(model: Model, region: Region, data, subopt=None) -> int:
    masked = subopt is not None and bool(subopt.points)
    if _prefer_native(region, masked=masked) \
            or not hw.exhaustive_on_device():
        res = _native_res(model, region, data, "score", subopt)
        if res is not None:
            return res.score
    if _is_small(region):
        return reference.find_score(model, region, data, subopt)
    return wavefront.find_score(model, region, data, subopt)


def find_path(model: Model, region: Region, data, subopt=None,
              threshold: Optional[int] = None,
              device=None) -> Optional[Alignment]:
    """(ref: Optimal_find_path, optimal.c): region scan then path DP."""
    masked = subopt is not None and bool(subopt.points)
    if _prefer_native(region, masked=masked):
        tb_bytes = ((region.query_length + 1)
                    * (region.target_length + 1)
                    * len(model.states) * 2)
        if tb_bytes <= _native_tb_budget():
            res = _native_res(model, region, data, "path", subopt)
            if res is not None:
                if threshold is not None and res.score < threshold:
                    return None
                return _to_alignment(model, region, res)
    if _is_small(region):
        from .. import observe
        observe.count_engine("oracle")
        res = reference.viterbi(model, region, data, "path", subopt)
        return _to_alignment(model, region, res)
    if hw.exhaustive_on_device():
        # reduced-space FIND_REGION on the device, then the traceback
        # DP only on the discovered alignment's bounding box (ref:
        # Optimal_find_path region-then-path, optimal.c).  The SubOpt
        # mask (Waterman-Eggert re-runs) rides along as a blocked-cell
        # plane, so the scan never rediscovers a masked alignment's box
        from .. import observe
        observe.count_engine("xla")
        scan = wavefront.find_region(model, region, data, subopt,
                                     device=device)
        if threshold is not None and scan.score < threshold:
            return None
        sub = Region(region.query_start + scan.query_start,
                     region.target_start + scan.target_start,
                     scan.query_end - scan.query_start,
                     scan.target_end - scan.target_start)
        if (sub.query_length < region.query_length
                or sub.target_length < region.target_length):
            return find_path(model, sub, data, subopt,
                             threshold=threshold, device=device)
    tb_bytes = ((region.query_length + 1) * (region.target_length + 1)
                * len(model.states) * 2)
    if tb_bytes <= _native_tb_budget():
        res = _native_res(model, region, data, "path", subopt)
        if res is not None:
            if threshold is not None and res.score < threshold:
                return None
            return _to_alignment(model, region, res)
    D = region.query_length + region.target_length + 1
    cube = D * (region.query_length + 1) * len(model.states)
    from .. import observe
    observe.count_engine("xla")
    if cube > DP_MEMORY_LIMIT:
        observe.note(2, f"path DP checkpointed: tb cube {cube >> 20} MB "
                        f"over --dpmemory {DP_MEMORY_LIMIT >> 20} MB")
        res = wavefront.find_path_checkpointed(
            model, region, data, subopt, budget_bytes=DP_MEMORY_LIMIT)
    else:
        res = wavefront.find_path(model, region, data, subopt,
                                  device=device)
    if threshold is not None and res.score < threshold:
        return None
    return _to_alignment(model, region, res)


def _is_small(region: Region) -> bool:
    return ((region.query_length + 1) * (region.target_length + 1)
            <= SMALL_DP_CELLS)


def _to_alignment(model: Model, region: Region,
                  res: DPResult) -> Optional[Alignment]:
    if res.path is None:
        return None
    al_region = Region(region.query_start + res.query_start,
                       region.target_start + res.target_start,
                       res.query_end - res.query_start,
                       res.target_end - res.target_start)
    return Alignment.from_path(model, al_region, res.score, res.path)
