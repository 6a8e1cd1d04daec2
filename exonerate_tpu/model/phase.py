"""Phased introns with split-codon scoring (ref: src/model/phase.c).

A phase model bundles three intron submodels — phase 0 (between codons),
phase 1 (codon split 1|2 across the intron) and phase 2 (split 2|1) — around
a codon match state.  The split-codon score translates the codon assembled
from the exon tail before the intron (located via the intron-start shadow
lane) plus the bases after it, exactly as the reference
(ref: src/model/phase.c:141-230).  All gathers are written against an array
module `xp` so they vectorize identically under NumPy and JAX.
"""
from __future__ import annotations

import numpy as np

from ..alphabet import AlphabetType
from ..submat import SYMBOL_INDEX
from ..translate import NT4
from .ir import IMPOSSIBLY_LOW_SCORE, Label, Model
from .match import Match, MatchType
from .data import AlignData
from .intron import intron_create, _shadow_value


_SEQV_MEMO: dict = {}


def _seq_vecs(seq):
    """Per-sequence nt4/symbol gathers, shared across every AlignData
    of a scan AND across warm runs in one process (content-keyed: each
    CLI run / serving query re-parses its FASTA, so id() keys miss)."""
    from ..seqio import seq_ckey
    key = seq_ckey(seq)
    hit = _SEQV_MEMO.get(key)
    if hit is not None:
        return hit
    v = (NT4[seq.data.astype(np.int32)], SYMBOL_INDEX[seq.data])
    if len(_SEQV_MEMO) > 64:
        _SEQV_MEMO.clear()
    _SEQV_MEMO[key] = v
    return v


def _seq_cache(data: AlignData):
    cache = getattr(data, "_phase_cache", None)
    if cache is None:
        code = data.mas.translate
        q_nt4, q_sym = _seq_vecs(data.query)
        t_nt4, t_sym = _seq_vecs(data.target)
        cache = {
            "q_nt4": q_nt4,
            "t_nt4": t_nt4,
            "q_sym": q_sym,
            "t_sym": t_sym,
            # packed codon -> protein-submat row index, one gather
            "trans_idx": SYMBOL_INDEX[code.trans],
        }
        data._phase_cache = cache
    return cache


def _codon_index(xp, nt4_arr, trans_idx, p1, p2, p3, n):
    c = xp.clip
    packed = (xp.take(nt4_arr, c(p1, 0, n - 1))
              | (xp.take(nt4_arr, c(p2, 0, n - 1)) << 4)
              | (xp.take(nt4_arr, c(p3, 0, n - 1)) << 8))
    return xp.take(trans_idx, packed)


def _make_split_shadow_fn(match_type: MatchType, phase: int,
                          on_query: bool, on_target: bool):
    """Split-codon calc (ref: Phase_CalcFunc, src/model/phase.c:196-230):
    codon positions come from the intron-start shadow on the intron side and
    from the source position on the other; the translated pair is scored
    through the protein submat."""
    q_is_dna = match_type in (MatchType.DNA2PROTEIN, MatchType.CODON2CODON)
    t_is_dna = match_type in (MatchType.PROTEIN2DNA, MatchType.CODON2CODON)

    def positions(xp, pos, start, has_intron):
        if phase == 1:
            p1 = (start - 1) if has_intron else (pos - 1)
            return p1, pos, pos + 1
        p1 = (start - 2) if has_intron else (pos - 2)
        p2 = (start - 1) if has_intron else (pos - 1)
        return p1, p2, pos

    def shadow_fn(xp, grid_val, svals, inputs, qpos, tpos):
        psub = inputs["psub"]
        valid = True
        # validity (ref: Phase_calc_is_valid, phase.c:176-188)
        if q_is_dna:
            if on_query:
                qstart = _shadow_value(svals, "query intron")
                valid = valid & (qstart >= phase)
            else:
                valid = valid & (qpos >= phase)
        if t_is_dna:
            if on_target:
                tstart = _shadow_value(svals, "target intron")
                valid = valid & (tstart >= phase)
            else:
                valid = valid & (tpos >= phase)
        # query side symbol index
        if q_is_dna:
            qstart = _shadow_value(svals, "query intron") if on_query else 0
            qp = positions(xp, qpos, qstart, on_query)
            qi = _codon_index(xp, inputs["q_nt4"], inputs["trans_idx"],
                              *qp, inputs["q_nt4"].shape[0])
        else:
            qi = xp.take(inputs["q_sym"],
                         xp.clip(qpos, 0, inputs["q_sym"].shape[0] - 1))
        if t_is_dna:
            tstart = _shadow_value(svals, "target intron") if on_target else 0
            tp = positions(xp, tpos, tstart, on_target)
            ti = _codon_index(xp, inputs["t_nt4"], inputs["trans_idx"],
                              *tp, inputs["t_nt4"].shape[0])
        else:
            ti = xp.take(inputs["t_sym"],
                         xp.clip(tpos, 0, inputs["t_sym"].shape[0] - 1))
        score = psub[qi, ti] if xp is np else xp.asarray(psub)[qi, ti]
        return xp.where(valid, score, IMPOSSIBLY_LOW_SCORE)

    return shadow_fn


def _phase_shadow_inputs(region, data: AlignData):
    cache = _seq_cache(data)
    return {"q_nt4": cache["q_nt4"], "t_nt4": cache["t_nt4"],
            "q_sym": cache["q_sym"], "t_sym": cache["t_sym"],
            "trans_idx": cache["trans_idx"],
            "psub": data.mas.protein_submat.matrix}


def _zero_grid(region, data):
    return np.int32(0)


def phase_create(suffix, match: Match, on_query: bool, on_target: bool,
                 intron_args=None) -> Model:
    """(ref: Phase_create, src/model/phase.c:364-545)."""
    assert on_query or on_target
    against_peptide = match.type in (MatchType.PROTEIN2DNA,
                                     MatchType.DNA2PROTEIN)
    assert not ((on_query and on_target) and against_peptide)
    full_suffix = "phase" + (f" {suffix} " if suffix else "") \
        + ("Q" if on_query else "-") + ("T" if on_target else "-")
    m = Model(full_suffix)
    intron_00 = intron_create(f"0:0 {full_suffix}", on_query, on_target,
                              True, intron_args)
    intron_12 = intron_create(f"1:2 {full_suffix}", on_query, on_target,
                              True, intron_args)
    intron_21 = intron_create(f"2:1 {full_suffix}", on_query, on_target,
                              True, intron_args)
    # advances (ref: phase.c:385-424)
    if against_peptide:
        if on_query:
            pre1, post1 = (1, 0), (2, 1)
            pre2, post2 = (2, 0), (1, 1)
        else:
            pre1, post1 = (0, 1), (1, 2)
            pre2, post2 = (0, 2), (1, 1)
    else:
        pre1, post1 = (1, 1), (2, 2)
        pre2, post2 = (2, 2), (1, 1)

    _mt = match.type
    phase1_calc = m.add_calc(
        f"phase1post to dst {full_suffix}", match.max_score(),
        grid_fn=_zero_grid,
        shadow_fn=_make_split_shadow_fn(match.type, 1, on_query, on_target),
        shadow_inputs_fn=_phase_shadow_inputs,
        max_score_fn=lambda data: data.match(_mt).max_score())
    phase2_calc = m.add_calc(
        f"phase2post to dst {full_suffix}", match.max_score(),
        grid_fn=_zero_grid,
        shadow_fn=_make_split_shadow_fn(match.type, 2, on_query, on_target),
        shadow_inputs_fn=_phase_shadow_inputs,
        max_score_fn=lambda data: data.match(_mt).max_score())
    q_is_dna = match.type in (MatchType.DNA2PROTEIN, MatchType.CODON2CODON)
    t_is_dna = match.type in (MatchType.PROTEIN2DNA, MatchType.CODON2CODON)
    for _pc, _ph in ((phase1_calc, 1), (phase2_calc, 2)):
        _pc.native_shadow = ("split_codon",
                             {"phase": _ph, "q_is_dna": q_is_dna,
                              "t_is_dna": t_is_dna,
                              "on_query": on_query,
                              "on_target": on_target})

    p1pre = m.add_state(f"phase1pre {full_suffix}")
    p1post = m.add_state(f"phase1post {full_suffix}")
    p2pre = m.add_state(f"phase2pre {full_suffix}")
    p2post = m.add_state(f"phase2post {full_suffix}")

    m.add_transition(f"(START) to {p1pre.name}", None, p1pre,
                     pre1[0], pre1[1], None, Label.SPLIT_CODON)
    m.add_transition(f"(START) to {p2pre.name}", None, p2pre,
                     pre2[0], pre2[1], None, Label.SPLIT_CODON)
    p1post_t = m.add_transition(f"{p1post.name} to (END)", p1post, None,
                                post1[0], post1[1], phase1_calc,
                                Label.SPLIT_CODON)
    p2post_t = m.add_transition(f"{p2post.name} to (END)", p2post, None,
                                post2[0], post2[1], phase2_calc,
                                Label.SPLIT_CODON)
    m.insert(intron_00, None, None)
    m.insert(intron_12, p1pre, p1post)
    m.insert(intron_21, p2pre, p2post)
    # wire the intron-start shadows of the phased introns into the split
    # calcs (ref: phase.c:520-538)
    if on_query and on_target:
        assert len(m.shadows) == 6
        for sh in m.shadows[2:4]:
            sh.dst_transitions.append(p1post_t)
        for sh in m.shadows[4:6]:
            sh.dst_transitions.append(p2post_t)
    else:
        assert len(m.shadows) == 3
        m.shadows[1].dst_transitions.append(p1post_t)
        m.shadows[2].dst_transitions.append(p2post_t)
    # closed before insertion, like the reference (ref: phase.c:544) —
    # see the ordering note in intron.intron_create
    m.close()
    return m
