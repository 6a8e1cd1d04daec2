"""Alignment objects: region + (transition, length) operation list.

Equivalent of the reference Alignment module core
(ref: src/c4/alignment.{h,c}): holds the path through a model, validates it,
computes per-transition scores and the equivalenced statistics behind
%id/%similarity and --percent thresholds.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..engine.region import Region
from ..model.ir import Label, Model, Transition
from ..seqio import Sequence


@dataclass
class AlignmentArgs:
    """(ref: Alignment_ArgumentSet, alignment.c:24-38)."""
    alignment_width: int = 80
    forward_strand_coords: bool = True
    use_aa_tla: bool = True


@dataclass
class AlignmentOperation:
    transition: Transition
    length: int


class Alignment:
    """(ref: Alignment, src/c4/alignment.h:39-96)."""

    def __init__(self, model: Model, region: Region, score: int):
        self.model = model
        self.region = region
        self.score = score
        self.ops: list[AlignmentOperation] = []

    def add(self, transition: Transition, length: int):
        """Append or merge; negative lengths trim the previous same-
        transition run, dropping it at zero (ref: Alignment_add,
        alignment.c — SAR assembly uses negative adds to un-emit HSP
        cells consumed by join/span regions)."""
        if self.ops and self.ops[-1].transition is transition:
            self.ops[-1].length += length
            assert self.ops[-1].length >= 0
            if self.ops[-1].length == 0:
                self.ops.pop()
        else:
            self.ops.append(AlignmentOperation(transition, length))

    @classmethod
    def from_path(cls, model: Model, region: Region, score: int,
                  path: list[Transition]) -> "Alignment":
        a = cls(model, region, score)
        for t in path:
            a.add(t, 1)
        return a

    # -- geometry ----------------------------------------------------------

    def is_valid(self) -> bool:
        """Re-walk the path against the region (ref: Alignment_is_valid)."""
        i = j = 0
        for op in self.ops:
            i += op.transition.advance_query * op.length
            j += op.transition.advance_target * op.length
        return (i == self.region.query_length
                and j == self.region.target_length)

    def coordinate(self, query: Sequence, target: Sequence,
                   on_query: bool, report_start: bool,
                   args: Optional[AlignmentArgs] = None) -> int:
        """Reported coordinate with forward-strand flip
        (ref: Alignment_get_coordinate, alignment.c:177-207)."""
        args = args or AlignmentArgs()
        if on_query:
            pos = (self.region.query_start if report_start
                   else self.region.query_end)
            if args.forward_strand_coords and query.strand == "-":
                pos = query.len - pos
        else:
            pos = (self.region.target_start if report_start
                   else self.region.target_end)
            if args.forward_strand_coords and target.strand == "-":
                pos = target.len - pos
        return pos

    def gene_orientation(self) -> str:
        """(ref: Alignment_get_gene_orientation, alignment.c:164-175)."""
        for op in self.ops:
            if op.transition.label == Label.SS5:
                return "+"
            if op.transition.label == Label.SS3:
                return "-"
        return "."

    # -- walking -----------------------------------------------------------

    def walk(self):
        """Yield (op, query_pos, target_pos) with absolute start positions."""
        qp = self.region.query_start
        tp = self.region.target_start
        for op in self.ops:
            yield op, qp, tp
            qp += op.transition.advance_query * op.length
            tp += op.transition.advance_target * op.length

    def grouped(self):
        """Group consecutive ops sharing a transition
        (ref: AlignmentView_prepare grouping)."""
        out: list[AlignmentOperation] = []
        for op in self.ops:
            if out and out[-1].transition is op.transition:
                out[-1] = AlignmentOperation(op.transition,
                                             out[-1].length + op.length)
            else:
                out.append(AlignmentOperation(op.transition, op.length))
        return out

    # -- statistics (ref: alignment.c:1383-1462) --------------------------

    def _match_symbol(self, seq: Sequence, pos: int, advance: int,
                      translate) -> int:
        if advance == 1:
            return seq.symbol(pos)
        assert advance == 3
        return translate.codon(seq.symbol(pos), seq.symbol(pos + 1),
                               seq.symbol(pos + 2))

    def equivalenced_total(self) -> int:
        """Number of equivalenced (match-transition) positions."""
        return sum(op.length for op in self.ops
                   if op.transition.label == Label.MATCH)

    def equivalenced_matching(self, query: Sequence, target: Sequence,
                              translate, report_id: bool,
                              data=None) -> int:
        """Count identities (report_id) or positives
        (ref: Alignment_get_equivalenced_matching)."""
        from ..engine.reference import _materialize_grids, _grid_value
        count = 0
        grids = None
        for op, qp, tp in self.walk():
            t = op.transition
            if t.label != Label.MATCH:
                continue
            for k in range(op.length):
                cq = qp + t.advance_query * k
                ct = tp + t.advance_target * k
                if report_id:
                    qs = self._match_symbol(query, cq, t.advance_query,
                                            translate)
                    ts = self._match_symbol(target, ct, t.advance_target,
                                            translate)
                    if chr(qs).upper() == chr(ts).upper():
                        count += 1
                else:
                    if grids is None:
                        grids = _materialize_grids(self.model, self.region,
                                                   data)
                    g = grids[id(t.calc)]
                    if _grid_value(g, cq - self.region.query_start,
                                   ct - self.region.target_start) > 0:
                        count += 1
        return count

    def percent_id(self, query, target, translate) -> float:
        total = self.equivalenced_total()
        if not total:
            return 0.0
        return (self.equivalenced_matching(query, target, translate, True)
                / total) * 100.0

    def percent_similarity(self, query, target, translate, data) -> float:
        total = self.equivalenced_total()
        if not total:
            return 0.0
        return (self.equivalenced_matching(query, target, translate, False,
                                           data) / total) * 100.0

    def match_score(self, data) -> int:
        """Sum of match-transition scores (for --percent,
        ref: Alignment_get_match_score)."""
        from ..engine.reference import _materialize_grids, _grid_value
        grids = _materialize_grids(self.model, self.region, data)
        total = 0
        for op, qp, tp in self.walk():
            t = op.transition
            if t.label != Label.MATCH:
                continue
            for k in range(op.length):
                total += _grid_value(
                    grids[id(t.calc)],
                    qp - self.region.query_start + t.advance_query * k,
                    tp - self.region.target_start + t.advance_target * k)
        return total

    def self_match_score(self, query: Sequence, target: Sequence,
                         data) -> int:
        """Max possible score over equivalenced positions
        (ref: Alignment_get_self_match_score)."""
        total = 0
        for op, qp, tp in self.walk():
            t = op.transition
            if t.label != Label.MATCH:
                continue
            if t.label_data is None:
                continue
            # resolve through the run's AlignData: user submats must reach
            # the %ps denominator (ref: Alignment_get_self_match_score uses
            # the ArgumentSet-built Match vtable)
            match = data.match(t.label_data.type)
            for k in range(op.length):
                cq = qp + t.advance_query * k
                if t.advance_query == 3:
                    code = match.mas.translate
                    aa = code.codon(query.symbol(cq), query.symbol(cq + 1),
                                    query.symbol(cq + 2))
                    total += match.mas.protein_submat.lookup(aa, aa)
                else:
                    s = query.symbol(cq)
                    total += match.submat.lookup(s, s)
        return total

    def percent_self(self, query, target, data) -> float:
        denom = self.self_match_score(query, target, data)
        if not denom:
            return 0.0
        return (self.match_score(data) / denom) * 100.0

    def __repr__(self):
        return (f"Alignment(score={self.score}, "
                f"q={self.region.query_start}..{self.region.query_end}, "
                f"t={self.region.target_start}..{self.region.target_end}, "
                f"{len(self.ops)} ops)")
