"""Waterman-Eggert suboptimal-alignment masking.

Equivalent of the reference SubOpt (ref: src/c4/subopt.{h,c}):
match positions of prior alignments block match transitions in later DPs.
Positions are stored absolutely; engines ask for a per-row boolean mask in
region-local coordinates (the dense replacement for the reference's
RangeTree + row index).
"""
from __future__ import annotations

from math import gcd

import numpy as np

from ..align.alignment import Alignment
from ..model.ir import Label
from .region import Region


class SubOpt:
    def __init__(self):
        self.points: set[tuple[int, int]] = set()
        self.by_row: dict[int, set[int]] = {}
        self.path_count = 0
        # per-path (qs, ts, path_id) arrays in add order; path_ids
        # (first writer wins) is derived lazily and extended
        # incrementally — only the BSDP walk reads it, while the hot
        # Waterman-Eggert loops only touch points/by_row
        self._paths: list[tuple[np.ndarray, np.ndarray, int]] = []
        self._path_ids: dict[tuple[int, int], int] = {}
        self._path_ids_done = 0      # paths already folded in

    def add_alignment(self, alignment: Alignment):
        """(ref: SubOpt_add_alignment, subopt.c:126-143).  Match-run
        points are generated vectorially (the per-point Python loop was
        ~0.2 s of a genome scan) and merged into points/by_row in bulk;
        semantics are identical to the reference's per-position adds."""
        qp = alignment.region.query_start
        tp = alignment.region.target_start
        qs_parts: list[np.ndarray] = []
        ts_parts: list[np.ndarray] = []
        for op in alignment.ops:
            t = op.transition
            if t.label == Label.MATCH:
                g = gcd(t.advance_query, t.advance_target)
                q_move = t.advance_query // g
                t_move = t.advance_target // g
                if op.length:
                    # run points: per step k of L, sub-positions m of g
                    steps = np.arange(op.length, dtype=np.int64)
                    subs = np.arange(g, dtype=np.int64)
                    qs_parts.append(
                        ((qp + steps * t.advance_query)[:, None]
                         + subs[None, :] * q_move).ravel())
                    ts_parts.append(
                        ((tp + steps * t.advance_target)[:, None]
                         + subs[None, :] * t_move).ravel())
                # block lead-in positions before the run (codon models:
                # the partial diagonal steps entering the first cell) —
                # the reference emits these for EVERY match op, even a
                # degenerate zero-length one
                # (ref: SubOpt_add_AlignmentOperation, subopt.c:100-122)
                if g > 1:
                    lead = np.arange(1, g, dtype=np.int64)
                    lx = qp - t.advance_query + lead * q_move
                    ly = tp - t.advance_target + lead * t_move
                    ok = (lx >= 0) & (ly >= 0)
                    qs_parts.append(lx[ok])
                    ts_parts.append(ly[ok])
            qp += t.advance_query * op.length
            tp += t.advance_target * op.length
        if qs_parts:
            qs = np.concatenate(qs_parts)
            ts = np.concatenate(ts_parts)
            self._paths.append((qs, ts, self.path_count))
            order = np.lexsort((qs, ts))
            ts_s, qs_s = ts[order], qs[order]
            rows, starts = np.unique(ts_s, return_index=True)
            bounds = np.append(starts[1:], len(ts_s))
            for r, a, b in zip(rows.tolist(), starts.tolist(),
                               bounds.tolist()):
                self.by_row.setdefault(r, set()).update(
                    qs_s[a:b].tolist())
            self.points.update(zip(qs.tolist(), ts.tolist()))
        self.path_count += 1

    @property
    def path_ids(self) -> dict[tuple[int, int], int]:
        """(q, t) -> 0-based id of the FIRST path that blocked it (the
        path_count value at add time, matching the eager per-point
        assignment this replaces; ref: SubOpt point payloads feeding
        SubOpt_find).  Extended incrementally so interleaved add/find
        (the BSDP clash checks) costs O(new points) per add."""
        ids = self._path_ids
        while self._path_ids_done < len(self._paths):
            qs, ts, pid = self._paths[self._path_ids_done]
            for p in zip(qs.tolist(), ts.tolist()):
                if p not in ids:
                    ids[p] = pid
            self._path_ids_done += 1
        return ids

    def find(self, region: Region, fn) -> bool:
        """First-match search over stored points inside the half-open
        rectangle (ref: SubOpt_find over RangeTree, subopt.c:166-175;
        RangeTree_inside_rectangle uses [start, start+length) bounds).
        fn(q, t, path_id) -> bool; True stops and is returned."""
        q_lo = region.query_start
        q_hi = region.query_start + region.query_length
        t_lo = region.target_start
        t_hi = region.target_start + region.target_length
        path_ids = self.path_ids
        for t in range(t_lo, t_hi):
            row = self.by_row.get(t)
            if not row:
                continue
            for q in sorted(row):
                if q_lo <= q < q_hi and fn(q, t, path_ids[(q, t)]):
                    return True
        return False

    def blocked_row(self, region: Region, j_local: int):
        """Boolean mask over region-local query positions for row j."""
        row = self.by_row.get(region.target_start + j_local)
        if not row:
            return None
        mask = np.zeros(region.query_length + 1, dtype=bool)
        for q in row:
            lq = q - region.query_start
            if 0 <= lq <= region.query_length:
                mask[lq] = True
        return mask

    def overlaps_region(self, region: Region) -> bool:
        """True if any blocked point falls inside the region (callers use
        this to know whether a mask-free precomputed DP is still valid)."""
        t_lo = region.target_start
        t_hi = region.target_start + region.target_length
        q_lo = region.query_start
        q_hi = region.query_start + region.query_length
        for t, row in self.by_row.items():
            if t_lo <= t <= t_hi and any(q_lo <= q <= q_hi for q in row):
                return True
        return False

    def blocked_grid(self, region: Region) -> np.ndarray:
        """Full [Q+1, T+1] mask (for the wavefront engine)."""
        mask = np.zeros((region.query_length + 1,
                         region.target_length + 1), dtype=bool)
        for (q, t) in self.points:
            lq, lt = q - region.query_start, t - region.target_start
            if 0 <= lq <= region.query_length \
                    and 0 <= lt <= region.target_length:
                mask[lq, lt] = True
        return mask
