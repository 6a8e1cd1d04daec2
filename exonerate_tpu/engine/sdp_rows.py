"""Row-scan SDP device tier: q-major band scans for short-query shapes.

The anti-diagonal band scan (sdp_device.py) steps W+Q+1 times — driven
by the compressed band width — while each step fills only ~Q vector
lanes.  For short queries over genome-scale targets (the protein2genome
north star: Q~150, W~160k) that shape lost to the host scheduler on the
earlier accelerator (BASELINE.md).  This engine executes the same
reference SDP recurrence (ref: src/sdp/sdp.c, src/sdp/scheduler.c)
TRANSPOSED: vectors along the compressed target W, `lax.scan` over the
Q+1 query rows, so the step count is the SHORT axis and every step is a
full-width vector operation (tools/kexp_row.py prototypes its cost
skeleton; not yet measured on the GPU).

Semantics (matching sdp_device.py, same candidate static order):

- vertical candidates (advance_query >= 1) read a ring of the last K
  fully-resolved rows, shifted along W by advance_target with absolute-
  target contiguity vetoes;
- within-row candidates (advance_query == 0, advance_target > 0) make
  the row a sequential system along t.  It is solved as a bounded
  fixpoint (Jacobi) iteration: each sweep re-evaluates every candidate
  in the reference's static order — (advance_target desc, advance_query
  desc, reverse-model-position asc), strict-> replacement — reading
  within-row sources from the previous sweep, and closes self-loop gap
  chains (delete states) in log2 doubling steps: the dropoff budget
  caps a gap run at ~dropoff/|gap_extend| columns, each chain carries
  its entry's path-max so per-chain expiry (dropoff + forward negative
  kill, both monotone along the chain) is exact
  (ref: Scheduler_Cell_process kill rules, scheduler.c:1008-1051);
- target-only spans (introns) freeze and thaw entirely WITHIN one query
  row (Scheduler_SpanData keys the stored seed by source q,
  scheduler.c:567-645), so the stored register becomes an inclusive/
  exclusive prefix maximum over submit values along the row
  (later submit replaces on >=, exactly the in-place copy semantics of
  scheduler.c:631-638), window-checked by absolute target entry;
- the reverse pass emits per-row boundary bit vectors (cells whose
  start state is >= 0 or span state > 0 at retirement,
  scheduler.c:965-1000) which the forward pass consumes directly as its
  per-row injection/thaw rows — no bit-plane transposition needed;
- joint/query-window spans (ner, genome2genome) are NOT expressible in
  a q-major sweep (the reference curr register walks (t, q)-lex across
  rows); those models keep the anti-diagonal tiers — see supported().

Like sdp_device, this engine returns only scores (per-locus best end
score, boundary planes, per-seed start scores for non-boundary models);
positions and tracebacks come from host band re-runs whose scores are
cross-checked (sdp_hybrid.py) — any disagreement, an unconverged row
fixpoint, edge liveness, or a cross-locus thaw falls the comparison
back to the host path, so byte parity never depends on this engine.

Known benign deviations from the sequential reference register
semantics, all caught by the score cross-check (same contract as the
diagonal engine's curr-register note):
- a gap chain absorbed by a better chain at a merge cell can resurface
  here after the better chain expires (the reference keeps one value
  per cell and loses the absorbed chain);
- a stored span seed that expires at a thaw consult deletes the
  reference's single-slot cache, hiding older in-window submits that
  this prefix formulation still sees (binds only when the band is
  wider than max_intron).
"""
from __future__ import annotations

import os
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..model.ir import (IMPOSSIBLY_LOW_SCORE, IMPOSSIBLY_HIGH_SCORE,
                        Model)
from .sdp_device import _plan_transitions, _span_plan, _pack_bits, \
    _unpack_bits

NEG = IMPOSSIBLY_LOW_SCORE
POS = IMPOSSIBLY_HIGH_SCORE

# Within-row Jacobi sweeps before the unconverged flag trips (-> host
# fallback).  Intron re-freeze relays cost ~3 sweeps each and the
# dropoff budget admits dozens of marginal same-row span crossings, so
# the tail is long (measured 29 on the est2genome differential
# fixture); the while_loop exits early per row, so only relay-heavy
# rows pay.
MAX_SWEEPS = 64


def sweep_settings() -> tuple[int, int]:
    """(max Jacobi sweeps per row, fixed sweep count or 0), from
    EXONERATE_TPU_SDP_ROWS_SWEEPS / _FIXED.  Read when a pass is built
    and part of get_fn's cache key, so changing them rebuilds."""
    return (int(os.environ.get("EXONERATE_TPU_SDP_ROWS_SWEEPS",
                               str(MAX_SWEEPS))),
            int(os.environ.get("EXONERATE_TPU_SDP_ROWS_FIXED", "0")))


def factored_plane(table, t_idx):
    """Score plane [n_rows, len(t_idx)] of a factored calc: column w is
    table[:, t_idx[w]].  An integer gather, exact for any int32 score
    (a one-hot float matmul would run in TF32 on a GPU by default,
    exact only up to 2^11)."""
    return jnp.take(table.astype(jnp.int32), t_idx, axis=1)


class RowUnsupported(Exception):
    """Model/pair not expressible by the row scan; use another tier."""


# ---------------------------------------------------------------------------
# static planning
# ---------------------------------------------------------------------------

def _row_plan(model: Model, is_forward: bool):
    """Candidate plan split for the q-major sweep: (adv candidates in
    static order with 'kind' in {vert, hedge, hself}, silent plan,
    chain map state_id -> self entry)."""
    adv, silent = _plan_transitions(model, is_forward)
    hself: dict[int, dict] = {}
    for k, e in enumerate(adv):
        if e["aq"] == 0 and e["at"] > 0 and e["read"] == e["write"]:
            if e["write"] in hself:
                raise RowUnsupported("two within-row self loops on one "
                                     "state")
            e["kind"] = "hself"
            hself[e["write"]] = e
        elif e["aq"] == 0 and e["at"] > 0:
            e["kind"] = "hedge"
        else:
            e["kind"] = "vert"
        e["order"] = k
    for st, se in hself.items():
        others = [e["order"] for e in adv
                  if e is not se and e["write"] == st]
        self_first = all(se["order"] < k for k in others)
        self_last = all(se["order"] > k for k in others)
        if not (self_first or self_last):
            raise RowUnsupported("chain entries straddle the self loop "
                                 "in candidate order")
        if se["shadow_starts"]:
            raise RowUnsupported("shadow start on a chain self loop")
        if se["p_under"] or se["p_over"]:
            raise RowUnsupported("protect clamp on a chain self loop")
        se["self_first"] = self_first
    return adv, silent, hself


def _silent_chain_reads_final(model: Model, is_forward: bool) -> bool:
    """Silent transitions feeding within-row chain states must read
    sources whose own silent writers all run earlier in the per-cell
    order (the chain entries are evaluated from converged row finals,
    which must equal the mid-cell running value the reference read)."""
    adv, silent, hself = _row_plan(model, is_forward)
    for e in silent:
        if e["write"] not in hself:
            continue
        writers = [s["rix"] for s in silent if s["write"] == e["read"]]
        if any(w > e["rix"] for w in writers):
            return False
        # the self push must also run after the silent write, so the
        # chain reads the silent-fed value (rix = per-cell order)
        if e["rix"] > hself[e["write"]]["rix"]:
            return False
    return True


def supported(model: Model) -> bool:
    """Can the q-major row scan express this model exactly (modulo the
    documented cross-check-caught register deviations)?"""
    from . import sdp_device
    if not sdp_device.supported(model):
        return False
    for sp in model.spans:
        if sp.max_query and sp.max_target:
            return False          # joint spans walk (t, q)-lex curr
    span_states = {sp.span_state.id for sp in model.spans}
    seed_states = {model.start_state.state.id, model.end_state.state.id}
    try:
        for fwd in (True, False):
            adv, silent, hself = _row_plan(model, fwd)
            for st, se in hself.items():
                if se["calc"] is None:
                    return False  # free self loop: unbounded chain
                if st in seed_states:
                    return False  # injection would bypass the closure
            for e in silent:
                if e["write"] in span_states:
                    # a silent write into a span state would be missed
                    # by the loop-position submit (none in the zoo)
                    return False
            if not _silent_chain_reads_final(model, fwd):
                return False
    except RowUnsupported:
        return False
    return True


def chain_ext_values(model: Model, pair) -> tuple:
    """Static scalar extend values per (is_forward, state_id) chain.
    Raises RowUnsupported when a self-loop calc is not a non-positive
    scalar for this pair (the doubling closure needs a static decay)."""
    out = []
    for fwd in (True, False):
        _adv, _silent, hself = _row_plan(model, fwd)
        for st, se in sorted(hself.items()):
            g = pair.grids.get(id(se["calc"]))
            if g is None or np.ndim(g) != 0:
                raise RowUnsupported("chain self calc is not scalar")
            ext = int(g)
            if ext > 0:
                raise RowUnsupported("positive gap extend")
            out.append((fwd, st, ext))
    return tuple(out)


def _lane_liveness(model: Model) -> list[tuple[int, int]]:
    """(state_id, designation) pairs whose shadow lane can carry a
    consumable value (backward closure from shadow_fn readers)."""
    adv, silent = _plan_transitions(model, True)
    need: set[tuple[int, int]] = set()
    for e in adv + silent:
        if e["calc"] is not None and e["calc"].shadow_fn is not None:
            for _name, des in e["dst_shadows"]:
                need.add((e["read"], des))
    changed = True
    while changed:
        changed = False
        for e in adv + silent:
            started = {des for des, _k, _v in e["shadow_starts"]}
            for (s, des) in list(need):
                if s == e["write"] and des not in started \
                        and (e["read"], des) not in need:
                    need.add((e["read"], des))
                    changed = True
    return sorted(need)


# ---------------------------------------------------------------------------
# traced builder
# ---------------------------------------------------------------------------

def build_row_pass(model: Model, Qp: int, Wp: int, kinds: tuple,
                   use_boundary: bool, n_seed_pad: int, n_seg_pad: int,
                   dropoff: int, chain_exts: tuple,
                   max_sweeps: int = MAX_SWEEPS, fixed_sweeps: int = 0):
    """Trace the fused reverse+forward q-major band scan.  Returns
    run(inputs) -> {'band_end': [n_seg_pad], 'live', 'xband',
    'unconverged', 'start_scores' (non-boundary only)}."""
    assert not model.is_open
    S = len(model.states)
    start_id = model.start_state.state.id
    end_id = model.end_state.state.id
    K = max(max((t.advance_query for t in model.transitions),
                default=1), 1)
    Wp1 = Wp + 1
    n_words = (Wp1 + 31) // 32
    spans = [sp for sp in _span_plan(model) if sp["max_target"] > 0
             and sp["max_query"] == 0]
    # query-only spans are reference no-ops (scheduler.c:619-641);
    # joint spans were rejected by supported()
    kind_map = dict(kinds)
    track_sid = not use_boundary
    ext_map = dict(((f, s), e) for f, s, e in chain_exts)
    lanes_live = _lane_liveness(model) if use_boundary else []
    lane_keys = {s: tuple(des for (s_l, des) in lanes_live if s_l == s)
                 for s in range(S)}
    prefix_levels = max(1, (Wp1 - 1).bit_length())

    col = np.arange(Wp1, dtype=np.int32)

    def shift_r(v, n, fill):
        if n == 0:
            return v
        return jnp.concatenate(
            [jnp.full((n,) + v.shape[1:], fill, v.dtype), v[:-n]])

    def shift_l(v, n, fill):
        if n == 0:
            return v
        return jnp.concatenate(
            [v[n:], jnp.full((n,) + v.shape[1:], fill, v.dtype)])

    def chain_levels(ext):
        if ext == 0:
            return prefix_levels
        lmax = dropoff // (-ext)
        return max(1, lmax.bit_length())

    def make_pass(is_forward: bool):
        adv_plan, silent_plan, hself = _row_plan(model, is_forward)
        has_lanes = is_forward and bool(lanes_live)
        has_sid = (not is_forward) and track_sid
        shf = (lambda v, n, fill: shift_r(v, n, fill)) if is_forward \
            else (lambda v, n, fill: shift_l(v, n, fill))

        def build_row_ctx(q, inputs, planes):
            """Sweep-invariant per-row quantities."""
            qlen = inputs["_qlen"]
            wlen = inputs["_wlen"]
            colv = jnp.asarray(col)
            col_ok = colv <= wlen
            cell_ok = col_ok & (q <= qlen)
            abs_tv = inputs["_abs_t"][:Wp1]
            seg_row = inputs["_seg"][:Wp1]
            ctx = dict(q=q, qlen=qlen, wlen=wlen, cell_ok=cell_ok,
                       abs_tv=abs_tv, seg_row=seg_row,
                       contig={}, cmemo={}, planes=planes)
            return ctx

        def contig(ctx, d):
            """Contiguity mask for a within-row move of d columns:
            abs target positions differ by exactly d (abs_t strictly
            increases inside a band, so endpoint contiguity implies
            every intermediate step)."""
            m = ctx["contig"].get(d)
            if m is None:
                a = ctx["abs_tv"]
                if is_forward:
                    m = (a - shift_r(a, d, -(1 << 30))) == d
                else:
                    m = (shift_l(a, d, -(1 << 30)) - a) == d
                ctx["contig"][d] = m
            return m

        def calc_vec(ctx, e, inputs):
            """Transition score vector [Wp1] at the calc position:
            forward = source cell (q - aq, t - at) -> shift by at;
            reverse = destination cell (q, t) -> unshifted
            (ref: scheduler.c:880-886 role swap).

            Factored calcs read a per-query-symbol score PLANE
            (precomputed once per call, see _factored_planes): on the
            accelerator this tier was written for, gathers ran
            near-serial, so a per-row `take(row, t_idx)` dominated the
            whole scan; a one-hot select over <=32 plane rows fuses
            into the step's elementwise bundle instead."""
            c = e["calc"]
            if c is None:
                return jnp.zeros((), jnp.int32)
            ci = model.calcs.index(c)
            at = e["at"] if is_forward else 0
            qi_off = e["aq"] if is_forward else 0
            key = (ci, at, qi_off)
            got = ctx["cmemo"].get(key)
            if got is not None:
                return got
            kind = kind_map.get(f"c{ci}")
            v = inputs[f"c{ci}"]
            qi = jnp.clip(ctx["q"] - qi_off, 0, Qp)
            if kind == "qt":
                out = v["q"][qi] + shf(v["t"][:Wp1], at, 0)
            elif kind == "factored":
                plane = ctx["planes"].get(ci)
                qsel = v["q_idx"][qi]
                if plane is not None:
                    n_rows = plane.shape[0]
                    g = jnp.broadcast_to(jnp.int32(0), (Wp1,))
                    for k in range(n_rows):
                        g = jnp.where(qsel == k, plane[k], g)
                else:
                    g = jnp.take(v["table"][qsel], v["t_idx"][:Wp1])
                qo = v["q_over"][qi]
                out = jnp.where(qo != 0, qo, shf(g, at, 0))
            elif kind == "scalar":
                out = jnp.broadcast_to(v, (Wp1,))
            elif kind == "qvec":
                out = jnp.broadcast_to(v[qi], (Wp1,))
            else:
                out = shf(v[:Wp1], at, 0)
            ctx["cmemo"][key] = out
            return out

        def apply_shadow_fn(ctx, e, inputs, base, lanes_src):
            c = e["calc"]
            if not is_forward or c is None or c.shadow_fn is None:
                return base
            ci = model.calcs.index(c)
            svals = {name: lanes_src.get(des, jnp.zeros(Wp1, jnp.int32))
                     for name, des in e["dst_shadows"]}
            at = e["at"]
            qpos = ctx["q"] - e["aq"]
            tpos = shf(ctx["abs_tv"], at, 0)
            return c.shadow_fn(jnp, base, svals, inputs[f"sh{ci}"],
                               qpos, tpos)

        def eval_cand(ctx, e, src, inputs):
            """src = (s_sc, s_pm, s_sd, s_ln dict) already shifted to
            destination columns.  Returns (val, ok, s_pm, s_sd, s_ln)."""
            s_sc, s_pm, s_sd, s_ln = src
            tsc = jnp.zeros((), jnp.int32)
            if e["rev_shadowed"]:
                pass                      # reverse scores shadows as 0
            elif e["calc"] is not None:
                tsc = calc_vec(ctx, e, inputs)
                tsc = apply_shadow_fn(ctx, e, inputs, tsc, s_ln)
            val = s_sc + tsc
            if e["p_under"]:
                val = jnp.maximum(val, NEG)
            if e["p_over"]:
                val = jnp.minimum(val, POS)
            ok = ctx["cell_ok"] & (s_sc > NEG)
            if e["at"]:
                ok &= contig(ctx, e["at"])
            if e["aq"]:
                ok &= (ctx["q"] - e["aq"] >= 0) if is_forward \
                    else (ctx["q"] + e["aq"] <= ctx["qlen"])
            if is_forward:
                ok &= val >= 0
            ok &= (s_pm - val) <= dropoff
            return val, ok, s_pm, s_sd, s_ln

        def shifted_src(rows, e):
            """Fetch + shift a source state's row tuple for candidate e.
            rows: (sc, pm, sd, ln) of the source ROW (previous-rows ring
            entry for verticals, the current row estimate for within-row
            candidates)."""
            sc_t, pm_t, sd_t, ln_t = rows
            r = e["read"]
            at = e["at"]
            s_sc = shf(sc_t[r], at, NEG)
            s_pm = shf(pm_t[r], at, NEG)
            s_sd = shf(sd_t[r], at, 0) if has_sid else None
            s_ln = None
            if has_lanes:
                s_ln = {des: shf(v, at, 0)
                        for des, v in ln_t[r].items()}
            return s_sc, s_pm, s_sd, s_ln

        def accept(state, e, val, ok, s_pm, s_sd, s_ln, ctx):
            """First-writer-wins merge into the running row state."""
            sc, pm, sd, ln, ev_score, ev_sid = state
            w = e["write"]
            take = ok & (val > sc[w])
            sc[w] = jnp.where(take, val, sc[w])
            pm[w] = jnp.where(take, jnp.maximum(s_pm, val), pm[w])
            if has_sid:
                sd[w] = jnp.where(take, s_sd, sd[w])
            if has_lanes:
                new_ln = dict(s_ln) if s_ln else {}
                for des, start_kind, shvix in e["shadow_starts"]:
                    if shvix is not None:
                        vec = inputs_ref[0][f"shv{shvix}"][:Wp1]
                        pos = shf(vec, e["at"], 0)
                    elif start_kind == "query_pos":
                        pos = jnp.broadcast_to(ctx["q"] - e["aq"],
                                               (Wp1,)).astype(jnp.int32)
                    else:
                        pos = shf(ctx["abs_tv"], e["at"], 0)
                    new_ln[des] = pos
                for des in lane_keys[w]:
                    nv = new_ln.get(des, jnp.zeros(Wp1, jnp.int32))
                    ln[w][des] = jnp.where(take, nv, ln[w][des])
            if e["event"]:
                ev = take & (val >= s_pm)
                ev_score = jnp.where(ev, val, ev_score)
                if has_sid:
                    ev_sid = jnp.where(ev, s_sd, ev_sid)
            return sc, pm, sd, ln, ev_score, ev_sid

        def chain_close(ctx, st, entries):
            """Close a within-row self-loop chain from its entry
            accumulator (val, pm, sd, ln) using log2 doubling with
            per-chain expiry (see module docstring)."""
            se = hself[st]
            ext = ext_map[(is_forward, st)]
            at = se["at"]
            levels = chain_levels(ext)
            e_val, e_pm, e_sd, e_ln = entries
            bound = e_pm - dropoff
            if is_forward:
                bound = jnp.maximum(bound, 0)
            cur_v = e_val
            cur_b = jnp.where(e_val > NEG, bound, POS)
            cur_p = e_pm
            cur_s = e_sd
            cur_l = e_ln
            prefer_old = se["self_first"]
            for k in range(levels):
                d = at << k
                if d > Wp:
                    break
                dec = ext * (1 << k)
                sv = shf(cur_v, d, NEG)
                sb = shf(cur_b, d, POS)
                nv = sv + dec
                okm = contig(ctx, d) & (sv > NEG) & (nv >= sb) \
                    & (nv > NEG)
                nv = jnp.where(okm, nv, NEG)
                if prefer_old:
                    take = (nv > cur_v) | ((nv == cur_v) & (nv > NEG))
                else:
                    take = nv > cur_v
                cur_v = jnp.where(take, nv, cur_v)
                cur_b = jnp.where(take, sb, cur_b)
                cur_p = jnp.where(take, shf(cur_p, d, NEG), cur_p)
                if has_sid:
                    cur_s = jnp.where(take, shf(cur_s, d, 0), cur_s)
                if has_lanes:
                    cur_l = {des: jnp.where(take, shf(v, d, 0), v)
                             for des, v in cur_l.items()}
            return cur_v, cur_p, cur_s, cur_l

        def span_phase(ctx, state, h_final, thaw_row, inputs):
            """Target-only span freeze/thaw within the row
            (ref: scheduler.c:567-645).  Stored register == prefix max
            over submits (later-wins ties = the in-place copy of
            scheduler.c:631-638); thaw raises strictly."""
            sc, pm, sd, ln, ev_score, ev_sid = state
            xb = jnp.zeros((), bool)
            if not (is_forward and use_boundary and spans):
                return state, xb
            abs_tv = ctx["abs_tv"]
            seg_row = ctx["seg_row"]
            h_sc, h_pm, _h_sd, h_ln = h_final
            for sp in spans:
                st = sp["state"]
                if sp["submit_post_thaw"]:
                    sub_sc, sub_pm = h_sc[st], h_pm[st]
                    sub_ln = h_ln[st] if has_lanes else {}
                else:
                    sub_sc, sub_pm = sc[st], pm[st]
                    sub_ln = ln[st] if has_lanes else {}
                cand = ctx["cell_ok"] & (sub_sc >= 0)
                v = jnp.where(cand, sub_sc, NEG)
                # payloads ride the combine (fused selects are ~free
                # per level; gathers were near-serial where this tier
                # was first measured)
                pay = {"te": abs_tv, "sg": seg_row, "pm": sub_pm}
                if has_lanes:
                    for des in lane_keys[st]:
                        pay[f"l{des}"] = sub_ln.get(
                            des, jnp.zeros(Wp1, jnp.int32))
                # inclusive prefix max, later submit wins ties
                for k in range(prefix_levels):
                    d = 1 << k
                    if d > Wp:
                        break
                    sv = shift_r(v, d, NEG)
                    take = sv > v
                    v = jnp.where(take, sv, v)
                    pay = {n: jnp.where(take, shift_r(p, d, 0), p)
                           for n, p in pay.items()}
                if sp["submit_post_thaw"]:
                    # thaw precedes the loop submit in the per-cell
                    # order: same-cell submits are invisible
                    v = shift_r(v, 1, NEG)
                    pay = {n: shift_r(p, 1, 0) for n, p in pay.items()}
                ok = (v > NEG) & \
                    ((pay["te"] + sp["max_target"]) >= abs_tv)
                th = thaw_row & ok & (sc[st] < v)
                xb |= jnp.any(th & (pay["sg"] != seg_row))
                sc[st] = jnp.where(th, v, sc[st])
                pm[st] = jnp.where(th, pay["pm"], pm[st])
                if has_lanes:
                    for des in list(ln[st]):
                        ln[st][des] = jnp.where(th, pay[f"l{des}"],
                                                ln[st][des])
            return (sc, pm, sd, ln, ev_score, ev_sid), xb

        inputs_ref = [None]   # visible to accept() for shadow vecs

        def sweep(ctx, h_final, ring, inj, thaw_row, inputs):
            """One Jacobi sweep: full candidate-order merge reading
            within-row sources from h_final (previous sweep finals)."""
            neg = jnp.full(Wp1, NEG, jnp.int32)
            zero = jnp.zeros(Wp1, jnp.int32)
            inj_sc, inj_sid = inj
            sc = [neg] * S
            pm = [neg] * S
            sd = [zero] * S if has_sid else [None] * S
            ln = [{des: zero for des in lane_keys[s]}
                  for s in range(S)] if has_lanes else [None] * S
            seed_state = start_id if is_forward else end_id
            sc[seed_state] = inj_sc
            pm[seed_state] = inj_sc
            if has_sid:
                sd[seed_state] = inj_sid
            state = (sc, pm, sd, ln, neg, zero)
            chain_entries = {st: (neg, neg,
                                  zero if has_sid else None,
                                  ({des: zero for des in lane_keys[st]}
                                   if has_lanes else None))
                             for st in hself}
            # --- advancing merge (static candidate order) --------------
            for e in adv_plan:
                if e["kind"] == "hself":
                    continue     # folded into the chain closure
                if e["kind"] == "vert":
                    rows = ring[e["aq"] - 1]
                else:
                    rows = h_final
                cand = eval_cand(ctx, e, shifted_src(rows, e), inputs)
                if e["write"] in hself:
                    # accumulate entries with the same tie rule
                    ce = chain_entries[e["write"]]
                    val, ok, s_pm, s_sd, s_ln = cand
                    take = ok & (val > ce[0])
                    n_val = jnp.where(take, val, ce[0])
                    n_pm = jnp.where(take, jnp.maximum(s_pm, val),
                                     ce[1])
                    n_sd = (jnp.where(take, s_sd, ce[2])
                            if has_sid else None)
                    n_ln = ce[3]
                    if has_lanes:
                        n_ln = {des: jnp.where(
                            take,
                            (s_ln or {}).get(des,
                                             jnp.zeros(Wp1, jnp.int32)),
                            v) for des, v in ce[3].items()}
                    chain_entries[e["write"]] = (n_val, n_pm, n_sd,
                                                 n_ln)
                else:
                    state = accept(state, e, *cand, ctx)
            # silent-sourced chain entries (reverse gap closes): merge
            # the silent candidates into the entry accumulator reading
            # h_final sources, preserving the adv-then-silent order
            for e in silent_plan:
                if e["write"] not in hself:
                    continue
                src = (h_final[0][e["read"]], h_final[1][e["read"]],
                       h_final[2][e["read"]] if has_sid else None,
                       h_final[3][e["read"]] if has_lanes else None)
                val, ok, s_pm, s_sd, s_ln = eval_cand(ctx, e, src,
                                                      inputs)
                ce = chain_entries[e["write"]]
                take = ok & (val > ce[0])
                n_val = jnp.where(take, val, ce[0])
                n_pm = jnp.where(take, jnp.maximum(s_pm, val), ce[1])
                n_sd = jnp.where(take, s_sd, ce[2]) if has_sid else None
                n_ln = ce[3]
                if has_lanes:
                    n_ln = {des: jnp.where(
                        take,
                        (s_ln or {}).get(des, jnp.zeros(Wp1, jnp.int32)),
                        v) for des, v in ce[3].items()}
                chain_entries[e["write"]] = (n_val, n_pm, n_sd, n_ln)
            # --- chain closures ---------------------------------------
            sc, pm, sd, ln, ev_score, ev_sid = state
            for st in hself:
                cv, cp, cs, cl = chain_close(ctx, st,
                                             chain_entries[st])
                take = cv > sc[st]
                sc[st] = jnp.where(take, cv, sc[st])
                pm[st] = jnp.where(take, cp, pm[st])
                if has_sid:
                    sd[st] = jnp.where(take, cs, sd[st])
                if has_lanes and cl is not None:
                    for des in list(ln[st]):
                        ln[st][des] = jnp.where(take, cl[des],
                                                ln[st][des])
            state = (sc, pm, sd, ln, ev_score, ev_sid)
            # --- span thaw (before the silent sweep, as sdp_device) ---
            state, xb = span_phase(ctx, state, h_final, thaw_row,
                                   inputs)
            # --- silent sweep (reverse model order, running values) ---
            sc, pm, sd, ln, ev_score, ev_sid = state
            for e in silent_plan:
                src = (sc[e["read"]], pm[e["read"]],
                       sd[e["read"]] if has_sid else None,
                       ln[e["read"]] if has_lanes else None)
                cand = eval_cand(ctx, e, src, inputs)
                sc, pm, sd, ln, ev_score, ev_sid = accept(
                    (sc, pm, sd, ln, ev_score, ev_sid), e, *cand, ctx)
            # --- finalize ---------------------------------------------
            for s in range(S):
                sc[s] = jnp.where(ctx["cell_ok"], sc[s], NEG)
            return (tuple(sc), tuple(pm),
                    tuple(sd) if has_sid else (),
                    tuple(dict(d) for d in ln) if has_lanes else (),
                    ev_score, ev_sid, xb)

        def row_fixpoint(ctx, ring, inj, thaw_row, inputs):
            neg = jnp.full(Wp1, NEG, jnp.int32)
            zero = jnp.zeros(Wp1, jnp.int32)
            h0 = (tuple(neg for _ in range(S)),
                  tuple(neg for _ in range(S)),
                  tuple(zero for _ in range(S)) if has_sid else (),
                  tuple({des: zero for des in lane_keys[s]}
                        for s in range(S)) if has_lanes else ())

            def unpack(h):
                sc, pm, sd, lt = h
                ln = [dict(t) for t in lt] if has_lanes else \
                    [None] * S
                return (list(sc), list(pm),
                        list(sd) if has_sid else [None] * S, ln)

            def body(carry):
                h, _ev, _es, it, _ch, _xb = carry
                out = sweep(ctx, unpack(h), ring, inj, thaw_row,
                            inputs)
                sc, pm, sd, lt, ev_score, ev_sid, xb = out
                new_h = (sc, pm, sd, lt)
                diff = jnp.zeros((), bool)
                for a, b in zip(jax.tree_util.tree_leaves(h),
                                jax.tree_util.tree_leaves(new_h)):
                    diff |= jnp.any(a != b)
                return (new_h, ev_score, ev_sid, it + 1, diff, xb)

            def cond(carry):
                _h, _ev, _es, it, ch, _xb = carry
                return ch & (it < max_sweeps)

            init = (h0, jnp.full(Wp1, NEG, jnp.int32),
                    jnp.zeros(Wp1, jnp.int32), jnp.zeros((), jnp.int32),
                    jnp.ones((), bool), jnp.zeros((), bool))
            fixed = fixed_sweeps
            if fixed:
                carry = init
                for _ in range(fixed):
                    carry = body(carry)
                h, ev_score, ev_sid, n_it, changed, xb = carry
            else:
                h, ev_score, ev_sid, n_it, changed, xb = lax.while_loop(
                    cond, body, init)
            unconverged = changed            # hit max_sweeps still hot
            return unpack(h), ev_score, ev_sid, xb, unconverged, n_it

        def step(carry, xs):
            ring, acc, live, xband, unconv = carry
            q, inj_words, inputs, planes = xs
            inputs_ref[0] = inputs
            ctx = build_row_ctx(q, inputs, planes)
            neg = jnp.full(Wp1, NEG, jnp.int32)
            zero = jnp.zeros(Wp1, jnp.int32)
            # --- injection row ----------------------------------------
            thaw_row = jnp.zeros(Wp1, bool)
            if is_forward:
                if use_boundary:
                    bits = _unpack_bits(inj_words, Wp1) & ctx["cell_ok"]
                    inj_sc = jnp.where(bits, 0, NEG)
                    thaw_row = bits
                    inj_sid = zero
                else:
                    sdq = inputs["_seed_q"]
                    sdv = inputs["_seed_d"] - sdq
                    hit = (sdq == q) & (inputs["_seed_d"] >= 0)
                    sscore = (acc["rev_start"] - inputs["_seed_half"])
                    valid = hit & (acc["rev_start"] > NEG)
                    val = jnp.where(valid, sscore, NEG)
                    inj_sc = neg.at[jnp.where(valid, sdv, 0)].max(val)
                    inj_sid = zero
            else:
                sdq = inputs["_seed_q"]
                sdv = inputs["_seed_d"] - sdq
                hit = (sdq == q) & (inputs["_seed_d"] >= 0)
                val = jnp.where(hit, inputs["_seed_half"], NEG)
                inj_sc = neg.at[jnp.where(hit, sdv, 0)].max(val)
                if has_sid:
                    sids = jnp.where(hit,
                                     jnp.arange(n_seed_pad,
                                                dtype=jnp.int32), -1)
                    inj_sid = zero.at[jnp.where(hit, sdv, 0)].max(sids)
                    inj_sid = jnp.maximum(inj_sid, 0)
                else:
                    inj_sid = zero
            # --- the row ----------------------------------------------
            ((sc, pm, sd, ln), ev_score, ev_sid, xb, unc,
             n_it) = row_fixpoint(ctx, ring, (inj_sc, inj_sid),
                                  thaw_row, inputs)
            # --- liveness, events, boundary ---------------------------
            any_live = jnp.zeros(Wp1, bool)
            for s in range(S):
                any_live |= sc[s] > NEG
            edge = inputs["_edge"][:Wp1] & ctx["cell_ok"]
            live = live | jnp.any(any_live & edge)
            acc = dict(acc)
            acc["sweeps"] = jnp.maximum(acc["sweeps"], n_it)
            if is_forward:
                acc["col_end"] = jnp.maximum(acc["col_end"], ev_score)
                ys = (jnp.zeros((), jnp.uint32), n_it)
            else:
                if track_sid:
                    acc["rev_start"] = acc["rev_start"].at[
                        jnp.where(ev_score > NEG, ev_sid, 0)
                    ].max(jnp.where(ev_score > NEG, ev_score, NEG))
                flag = sc[start_id] >= 0
                for sp in spans:
                    flag |= sc[sp["state"]] > 0
                flag &= ctx["cell_ok"]
                ys = (_pack_bits(flag, n_words), n_it)
            row_final = (tuple(sc), tuple(pm),
                         tuple(sd) if has_sid else (),
                         tuple(dict(d) if d is not None else {}
                               for d in ln))
            ring = (row_final,) + ring[:-1]
            return (ring, acc, live, xband | xb, unconv | unc), ys

        return step

    step_rev = make_pass(False)
    step_fwd = make_pass(True)

    def init_ring(is_forward):
        neg = jnp.full(Wp1, NEG, jnp.int32)
        zero = jnp.zeros(Wp1, jnp.int32)
        has_lanes = is_forward and bool(lanes_live)
        has_sid = (not is_forward) and track_sid
        row = (tuple(neg for _ in range(S)),
               tuple(neg for _ in range(S)),
               tuple(zero for _ in range(S)) if has_sid else (),
               tuple({des: zero for des in lane_keys[s]}
                     if has_lanes else {} for s in range(S)))
        return tuple(row for _ in range(K))

    def _factored_planes(inputs):
        """Per-query-symbol factored score planes [n_rows, Wp1], built
        once per call; rows select them by symbol compare."""
        planes = {}
        for ci, _c in enumerate(model.calcs):
            if kind_map.get(f"c{ci}") != "factored":
                continue
            v = inputs[f"c{ci}"]
            n_rows, n_cols = v["table"].shape
            if n_rows > 32 or n_cols > 512:
                continue
            planes[ci] = factored_plane(v["table"], v["t_idx"][:Wp1])
        return planes

    def run(inputs):
        q_seq = jnp.arange(Qp + 1, dtype=jnp.int32)
        acc0 = {"col_end": jnp.full(Wp1, NEG, jnp.int32),
                "sweeps": jnp.zeros((), jnp.int32)}
        if track_sid:
            acc0["rev_start"] = jnp.full(n_seed_pad, NEG, jnp.int32)
        dummy_words = jnp.zeros((Qp + 1, n_words), jnp.uint32)
        planes = _factored_planes(inputs)

        def wrap(step_fn):
            def one(carry, xs):
                q, inj = xs
                return step_fn(carry, (q, inj, inputs, planes))
            return one

        carry0 = (init_ring(False), acc0, jnp.zeros((), bool),
                  jnp.zeros((), bool), jnp.zeros((), bool))
        (ring, acc, live_r, _xb, unc_r), (ys, rev_its) = lax.scan(
            wrap(step_rev), carry0, (q_seq, dummy_words), reverse=True)

        inj_words = ys if use_boundary else dummy_words
        carry1 = (init_ring(True), acc, jnp.zeros((), bool),
                  jnp.zeros((), bool), jnp.zeros((), bool))
        (ring, acc, live_f, xband, unc_f), (_fy, fwd_its) = lax.scan(
            wrap(step_fwd), carry1, (q_seq, inj_words))

        col_end = acc["col_end"]
        seg_row = inputs["_seg"][:Wp1]
        band_end = jnp.full(n_seg_pad, NEG, jnp.int32).at[
            jnp.where(col_end > NEG, seg_row, n_seg_pad - 1)
        ].max(col_end)
        out = {"band_end": band_end, "live": live_r | live_f,
               "xband": xband, "unconverged": unc_r | unc_f,
               "sweeps": acc["sweeps"],
               "row_sweeps_rev": rev_its, "row_sweeps_fwd": fwd_its}
        if track_sid:
            out["start_scores"] = acc["rev_start"]
        return out

    return run


_CACHE: dict = {}


def get_fn(model: Model, Qp: int, Wp: int, kinds: tuple,
           use_boundary: bool, n_seed_pad: int, n_seg_pad: int,
           dropoff: int, chain_exts: tuple, batched: bool = False):
    from ..model.ir import model_fingerprint
    sweeps = sweep_settings()
    key = (model_fingerprint(model), Qp, Wp, kinds, use_boundary,
           n_seed_pad, n_seg_pad, dropoff, chain_exts, batched, sweeps)
    if key not in _CACHE:
        fn = build_row_pass(model, Qp, Wp, kinds, use_boundary,
                            n_seed_pad, n_seg_pad, dropoff, chain_exts,
                            *sweeps)
        if batched:
            fn = jax.vmap(fn)
        _CACHE[key] = jax.jit(fn)
    return _CACHE[key]
