"""Device-resident SDP passes: the default heuristic's DP on the GPU.

This executes the reference SDP/Scheduler recurrence (ref: src/sdp/sdp.c,
src/sdp/scheduler.c:700-1100) as dense anti-diagonal scans over the
band-compressed target (see sdp_bands.py), with byte-exact semantics:

- processing order: the sparse scheduler visits cells in (t, q)
  lexicographic order and evaluates transitions in reverse model order,
  keeping the existing value on ties (first writer wins; ref:
  scheduler.c:887-888, 1048-1051).  In PULL form this is a *static*
  candidate order per destination cell: (advance_target desc,
  advance_query desc, reverse-model-position asc), strict-> replacement.
- silent (0,0) transitions apply *after* the advancing merge, in reverse
  model order, reading the running per-state value (all cross-cell reads
  in the model zoo see the final post-silent value, verified at
  build time).
- per-path maximum (pmax) lanes + dropoff pruning, forward kill of
  negative cells, protect clamps (ref: scheduler.c:1008-1051).
- span freeze/thaw: submits are a per-query-column running "best seed"
  carry (later submit wins ties, ref: Scheduler_SpanData_submit),
  thaw only at injected boundary cells with absolute-target window
  checks (ref: Scheduler_SpanData_get_curr, scheduler.c:567-645).
  The per-column `curr` register reproduces the reference's span_curr
  for target-only spans; the one known divergence (a stale equal-score
  curr payload surviving interleaved other-column thaws) is caught by
  the host consistency check in sdp_hybrid.py.
- reverse pass: scores shadowed transitions as 0, never kills negatives,
  and emits the boundary bit-planes (cells whose start state is >= 0 or
  whose span state is > 0 at retirement, ref: scheduler.c:965-1000)
  consumed directly as the forward pass's injection rows.

The kernel returns only *scores*: per-band best end score (and per-seed
start scores for non-boundary models, used to seed the forward pass
on-device).  Alignment positions and tracebacks for reported seeds come
from a host native re-run restricted to the winning band (sdp_hybrid.py),
whose scores are checked against the device's — any mismatch falls the
comparison back to the host global path, so parity is never at risk.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..model.ir import (IMPOSSIBLY_LOW_SCORE, IMPOSSIBLY_HIGH_SCORE,
                        Model, Protect)
from .region import Region
from .sdp_bands import BandPlan

NEG = IMPOSSIBLY_LOW_SCORE
POS = IMPOSSIBLY_HIGH_SCORE


# ---------------------------------------------------------------------------
# support predicate
# ---------------------------------------------------------------------------

def supported(model: Model) -> bool:
    """Can the device scan express this model exactly?

    Query/joint spans (ner, genome2genome) are supported via the
    lane-shifted curr register (see build_pass): the reference carries
    one curr register through the lex-(t, q) walk; its diagonal-scan
    image is a per-lane plane advanced one lane per diagonal, with
    pickups gated to thaw cells and the reference window checks
    (scheduler protocol, ref: scheduler.c:567-645).  Query-only spans
    mirror the reference submit no-op (scheduler.c:619-641).  Silent
    exits from span states (ner's `ner to match`) are handled by
    running the span thaw/submit phase before the silent sweep.  The
    q-window upper bound is only enforced for max_query >=
    query_length — callers gate smaller windows to the host path
    (sdp_hybrid)."""
    for sh in model.shadows:
        if sh.start_vec_fn is not None and sh.start != "target_pos":
            return False
    # all cross-cell (advancing) reads must see the final post-silent
    # value in both pass directions (holds for the whole zoo; guard it)
    rev = list(model.transitions)[::-1]
    for s in model.states:
        for direction in ("fwd", "rev"):
            if direction == "fwd":
                writes = [i for i, t in enumerate(rev)
                          if t.output is s and t.is_silent]
                reads = [i for i, t in enumerate(rev)
                         if t.input is s and not t.is_silent]
            else:
                writes = [i for i, t in enumerate(rev)
                          if t.input is s and t.is_silent]
                reads = [i for i, t in enumerate(rev)
                         if t.output is s and not t.is_silent]
            if writes and reads:
                full = len(writes)
                for r in reads:
                    if sum(1 for w in writes if w < r) != full:
                        return False
    return True


# ---------------------------------------------------------------------------
# host-side input preparation
# ---------------------------------------------------------------------------

def prepare_inputs(model: Model, pair, plan: BandPlan,
                   pad_to=None) -> tuple[dict, tuple]:
    """Compressed-target arrays from an SDPPair's materialized calc forms
    (grids/factored/qt built once per comparison by SDPPair.__init__).

    Returns (inputs, kinds); kinds is the static classification keyed
    into the jit cache."""
    Q = pair.region.query_length
    W = plan.W
    Qp, Wp = pad_to if pad_to is not None else (Q, W)
    abs_t = plan.abs_t
    inputs: dict = {}
    kinds: dict = {}

    def pad_q(v, fill=0):
        v = np.asarray(v)
        out = np.full((Qp + 1,) + v.shape[1:], fill, v.dtype)
        out[:Q + 1] = v
        return out

    def pad_w(v, fill=0):
        v = np.asarray(v)
        out = np.full((Wp + 1,) + v.shape[1:], fill, v.dtype)
        out[:W + 1] = v
        return out

    for ci, c in enumerate(model.calcs):
        key = f"c{ci}"
        if id(c) in pair.qt:
            qv, tv = pair.qt[id(c)]
            inputs[key] = {"q": pad_q(qv.astype(np.int32)),
                           "t": pad_w(tv[abs_t].astype(np.int32))}
            kinds[key] = "qt"
        elif id(c) in pair.factored:
            table, q_idx, t_idx, q_over = pair.factored[id(c)]
            inputs[key] = {
                "table": table.astype(np.int32),
                "q_idx": pad_q(q_idx.astype(np.int32),
                               fill=table.shape[0] - 1),
                "t_idx": pad_w(t_idx[abs_t].astype(np.int32),
                               fill=table.shape[1] - 1),
                "q_over": pad_q((q_over if q_over is not None
                                 else np.zeros(Q + 1)).astype(np.int32)),
            }
            kinds[key] = "factored"
        elif id(c) in pair.grids:
            g = pair.grids[id(c)]
            if g.ndim == 0:
                inputs[key] = np.int32(g)
                kinds[key] = "scalar"
            elif g.ndim == 2 and g.shape[0] > 1 and g.shape[1] > 1:
                raise ValueError("true 2-D grid unsupported on device")
            elif g.ndim == 2 and g.shape[0] > 1:
                inputs[key] = pad_q(g[:, 0].astype(np.int32))
                kinds[key] = "qvec"
            elif g.ndim == 2:
                inputs[key] = pad_w(g[0, abs_t].astype(np.int32))
                kinds[key] = "tvec"
            elif g.shape[0] == Q + 1:
                inputs[key] = pad_q(g.astype(np.int32))
                kinds[key] = "qvec"
            else:
                inputs[key] = pad_w(g[abs_t].astype(np.int32))
                kinds[key] = "tvec"
        if c.shadow_inputs_fn is not None:
            inputs[f"sh{ci}"] = pair.shadow_inputs[id(c)]
    for sx, sh in enumerate(model.shadows):
        if sh.start_vec_fn is not None:
            vec = np.asarray(sh.start_vec_fn(pair.region, pair.data))
            inputs[f"shv{sx}"] = pad_w(vec[abs_t].astype(np.int32))
    inputs["_abs_t"] = pad_w(abs_t.astype(np.int32), fill=-(10 ** 9))
    from .sdp_bands import edge_cols
    inputs["_edge"] = pad_w(
        edge_cols(plan.seg_id, plan.abs_t,
                  pair.region.target_length,
                  width=max(model.max_target_advance, 1)
                  ).astype(np.bool_))
    inputs["_seg"] = pad_w(plan.locus_of_v.astype(np.int32))
    inputs["_qlen"] = np.int32(Q)
    inputs["_wlen"] = np.int32(W)
    return inputs, tuple(sorted(kinds.items()))


def prepare_seeds(pair, plan: BandPlan, n_seed_pad: int) -> dict:
    """Seed arrays in compressed coordinates (global seed order)."""
    seeds = pair.seeds
    n = len(seeds)
    assert n <= n_seed_pad
    d_k = np.full(n_seed_pad, -1, np.int32)
    q_k = np.zeros(n_seed_pad, np.int32)
    half_k = np.zeros(n_seed_pad, np.int32)
    band_ix = 0
    for k, s in enumerate(seeds):
        while not (plan.bands[band_ix].t0 <= s.t_cobs
                   <= plan.bands[band_ix].t1):
            band_ix += 1
        v = plan.to_v(band_ix, s.t_cobs)
        d_k[k] = s.q_cobs + v
        q_k[k] = s.q_cobs
        half_k[k] = s.hsp_score >> 1
    return {"_seed_d": d_k, "_seed_q": q_k, "_seed_half": half_k,
            "_nseed": np.int32(n)}


# ---------------------------------------------------------------------------
# traced scan builder
# ---------------------------------------------------------------------------

def _plan_transitions(model: Model, is_forward: bool):
    """Static candidate plans: (advancing sorted by push order, silent in
    reverse-model order).  Each entry carries the roles for the pass
    direction (forward reads t.input/writes t.output; reverse the
    opposite, ref: scheduler.c:880-886)."""
    rev = list(model.transitions)[::-1]
    adv, silent = [], []
    span_states = {sp.span_state.id for sp in model.spans}
    start_id = model.start_state.state.id
    end_id = model.end_state.state.id
    for rix, t in enumerate(rev):
        is_loop = (t.input is t.output and t.calc is None
                   and not t.is_silent)
        if is_loop and t.input.id in span_states:
            continue                      # span loops never walk cells
        e = dict(
            t=t, rix=rix, aq=t.advance_query, at=t.advance_target,
            read=(t.input.id if is_forward else t.output.id),
            write=(t.output.id if is_forward else t.input.id),
            calc=t.calc,
            p_under=(t.calc is not None
                     and bool(t.calc.protect & Protect.UNDERFLOW)),
            p_over=(t.calc is not None
                    and bool(t.calc.protect & Protect.OVERFLOW)),
            rev_shadowed=(not is_forward and bool(t.dst_shadows)),
            event=(is_forward and t.output.id == end_id)
                  or (not is_forward and t.input.id == start_id),
            shadow_starts=[(sh.designation, sh.start,
                            (None if sh.start_vec_fn is None
                             else model.shadows.index(sh)))
                           for sh in model.src_shadows(t.input)]
            if is_forward else [],
            dst_shadows=[(sh.name, sh.designation)
                         for sh in t.dst_shadows],
        )
        if t.is_silent:
            silent.append(e)
        else:
            adv.append(e)
    adv.sort(key=lambda e: (-e["at"], -e["aq"], e["rix"]))
    silent.sort(key=lambda e: e["rix"])
    return adv, silent


def _span_plan(model: Model):
    """Per-span static info: state id, max_target/max_query windows, and
    whether the loop's submit reads the post-thaw value (thaw trigger
    position before the loop position in reverse model order)."""
    rev = list(model.transitions)[::-1]
    plans = []
    for sp in model.spans:
        st = sp.span_state
        # a span state may carry several loops (ner's insert+delete):
        # the reference submits at EACH loop position and replaces on
        # >=, and thaw only raises the value — so the net stored value
        # is post-thaw iff ANY loop follows the thaw trigger
        loop_pos = max(i for i, t in enumerate(rev)
                       if t.input is st and t.output is st
                       and t.calc is None)
        thaw_pos = min((i for i, t in enumerate(rev)
                        if t.input is st
                        and not (t.input is t.output and t.calc is None)),
                       default=10 ** 9)
        plans.append(dict(state=st.id, max_target=sp.max_target,
                          max_query=sp.max_query,
                          submit_post_thaw=thaw_pos < loop_pos))
    return plans


def _pack_bits(bits, n_words):
    """[Qp1] bool -> [n_words] int32 (little-endian bit order)."""
    pad = n_words * 32 - bits.shape[0]
    b = jnp.concatenate([bits, jnp.zeros(pad, bits.dtype)])
    b = b.reshape(n_words, 32).astype(jnp.uint32)
    return (b << jnp.arange(32, dtype=jnp.uint32)[None, :]).sum(
        axis=1, dtype=jnp.uint32)


def _unpack_bits(words, n):
    bits = (words[:, None] >> jnp.arange(32, dtype=jnp.uint32)[None, :]) & 1
    return bits.reshape(-1)[:n].astype(bool)


def build_pass(model: Model, Qp: int, Wp: int, kinds: tuple,
               use_boundary: bool, n_seed_pad: int, n_seg_pad: int,
               dropoff: int, debug_planes: bool = False, fold: int = 0):
    """Trace the fused reverse+forward band scan.  Returns
    run(inputs) -> {'band_end': [n_seg_pad], 'live': bool scalar,
    'start_scores': [n_seed_pad] (non-boundary only)}.  `fold`
    diagonals run per scan step (0: the platform's value,
    device.sdp_fold)."""
    assert not model.is_open
    if not fold:
        from .. import device
        fold = device.sdp_fold()
    S = len(model.states)
    n_sh = model.total_shadow_designations
    start_id = model.start_state.state.id
    end_id = model.end_state.state.id
    K = max(max((t.advance_query + t.advance_target
                 for t in model.transitions), default=1), 1)
    Dp = Qp + Wp + 1
    Qp1 = Qp + 1
    n_words = (Qp1 + 31) // 32
    spans = _span_plan(model)
    kind_map = dict(kinds)
    i_vec = np.arange(Qp1, dtype=np.int32)
    track_sid = not use_boundary   # reverse per-seed start attribution

    def calc_score(e, inputs, qi, ti):
        """Transition score at calc position (qi, ti vectors [Qp1])."""
        c = e["calc"]
        if c is None:
            return jnp.zeros((), jnp.int32)
        ci = model.calcs.index(c)
        kind = kind_map.get(f"c{ci}")
        v = inputs[f"c{ci}"]
        tic = jnp.clip(ti, 0, Wp)
        qic = jnp.clip(qi, 0, Qp)
        if kind == "qt":
            return jnp.take(v["q"], qic) + jnp.take(v["t"], tic)
        if kind == "factored":
            g = v["table"][jnp.take(v["q_idx"], qic),
                           jnp.take(v["t_idx"], tic)]
            qo = jnp.take(v["q_over"], qic)
            return jnp.where(qo != 0, qo, g)
        if kind == "scalar":
            return v
        if kind == "qvec":
            return jnp.take(v, qic)
        return jnp.take(v, tic)

    def apply_shadow_fn(e, inputs, base, lanes_src, qpos, tpos):
        c = e["calc"]
        if c is None or c.shadow_fn is None:
            return base
        ci = model.calcs.index(c)
        svals = {name: lanes_src[:, des]
                 for name, des in e["dst_shadows"]}
        return c.shadow_fn(jnp, base, svals, inputs[f"sh{ci}"],
                           qpos, tpos)

    def make_step(is_forward: bool):
        adv_plan, silent_plan = _plan_transitions(model, is_forward)
        has_lanes = is_forward and n_sh > 0
        has_sid = (not is_forward) and track_sid

        def step(carry, xs):
            prev, span_carry, acc, live, xband = carry
            d, inj_xs, inputs = xs
            i = jnp.asarray(i_vec)
            j = d - i
            qlen = inputs["_qlen"]
            wlen = inputs["_wlen"]
            cell_ok = (j >= 0) & (j <= wlen) & (i <= qlen)
            jc = jnp.clip(j, 0, Wp)
            abs_tv = jnp.take(inputs["_abs_t"], jc)
            neg = jnp.full(Qp1, NEG, jnp.int32)
            zero = jnp.zeros(Qp1, jnp.int32)

            # running per-state values
            sc = [neg] * S
            pm = [neg] * S
            sd = [zero] * S if has_sid else None
            ln = ([jnp.zeros((Qp1, n_sh), jnp.int32)] * S
                  if has_lanes else None)

            # --- seed / boundary injection (first occupant) -------------
            thaw_row = jnp.zeros(Qp1, bool)
            if is_forward:
                if use_boundary:
                    bits = _unpack_bits(inj_xs, Qp1) & cell_ok
                    sc[start_id] = jnp.where(bits, 0, NEG)
                    pm[start_id] = jnp.where(bits, 0, NEG)
                    thaw_row = bits
                else:
                    sdd = inputs["_seed_d"]
                    hit = sdd == d
                    sscore = (jnp.take(acc["rev_start"],
                                       jnp.arange(n_seed_pad))
                              - inputs["_seed_half"])
                    valid = hit & (acc["rev_start"] > NEG)
                    val = jnp.where(valid, sscore, NEG)
                    row = neg.at[jnp.where(
                        valid, inputs["_seed_q"], Qp)].max(val)
                    row = row.at[Qp].set(
                        jnp.where(qlen >= Qp, row[Qp], NEG))
                    sc[start_id] = row
                    pm[start_id] = row
            else:
                sdd = inputs["_seed_d"]
                hit = sdd == d
                val = jnp.where(hit, inputs["_seed_half"], NEG)
                row = neg.at[jnp.where(
                    hit, inputs["_seed_q"], Qp)].max(val)
                row = row.at[Qp].set(
                    jnp.where(qlen >= Qp, row[Qp], NEG))
                sc[end_id] = row
                pm[end_id] = row
                if has_sid:
                    sids = jnp.where(hit, jnp.arange(n_seed_pad,
                                                     dtype=jnp.int32), 0)
                    srow = zero.at[jnp.where(
                        hit, inputs["_seed_q"], Qp)].max(sids)
                    sd[end_id] = srow

            ev_score = neg      # running per-cell best event
            ev_sid = zero

            def eval_candidate(e, src_vals):
                """One candidate sweep; returns (val, ok, payload...)."""
                aq, at = e["aq"], e["at"]
                s_sc, s_pm, s_sd, s_ln = src_vals
                if is_forward:
                    si, sj = i - aq, j - at
                    calc_qi, calc_ti = si, sj
                else:
                    si, sj = i + aq, j + at
                    calc_qi, calc_ti = i, j
                src_ok = cell_ok & (si >= 0) & (si <= qlen) \
                    & (sj >= 0) & (sj <= wlen)
                if at:
                    # segment contiguity via absolute target positions
                    src_abs = jnp.take(inputs["_abs_t"],
                                       jnp.clip(sj, 0, Wp))
                    dst_abs = abs_tv if is_forward else src_abs
                    if is_forward:
                        src_ok &= (abs_tv - src_abs) == at
                    else:
                        src_ok &= (src_abs - abs_tv) == at
                if e["rev_shadowed"]:
                    tsc = jnp.zeros((), jnp.int32)
                elif e["calc"] is None:
                    tsc = jnp.zeros((), jnp.int32)
                else:
                    tsc = calc_score(e, inputs, calc_qi, calc_ti)
                    if is_forward and e["calc"].shadow_fn is not None:
                        qpos = calc_qi
                        tpos = jnp.take(inputs["_abs_t"],
                                        jnp.clip(calc_ti, 0, Wp))
                        tsc = apply_shadow_fn(e, inputs, tsc, s_ln,
                                              qpos, tpos)
                val = s_sc + tsc
                if e["p_under"]:
                    val = jnp.maximum(val, NEG)
                if e["p_over"]:
                    val = jnp.minimum(val, POS)
                ok = src_ok & (s_sc > NEG)
                if is_forward:
                    ok &= val >= 0
                ok &= (s_pm - val) <= dropoff
                return val, ok, s_pm, s_sd, s_ln

            def accept(e, val, ok, s_pm, s_sd, s_ln):
                nonlocal ev_score, ev_sid
                w = e["write"]
                take = ok & (val > sc[w])
                sc[w] = jnp.where(take, val, sc[w])
                new_pm = jnp.maximum(s_pm, val)
                pm[w] = jnp.where(take, new_pm, pm[w])
                if has_sid:
                    sd[w] = jnp.where(take, s_sd, sd[w])
                if has_lanes:
                    new_ln = s_ln
                    for des, start_kind, shvix in e["shadow_starts"]:
                        if shvix is not None:
                            pos = jnp.take(
                                inputs[f"shv{shvix}"],
                                jnp.clip(j - e["at"], 0, Wp))
                        elif start_kind == "query_pos":
                            pos = i - e["aq"]
                        else:
                            pos = jnp.take(
                                inputs["_abs_t"],
                                jnp.clip(j - e["at"], 0, Wp))
                        new_ln = new_ln.at[:, des].set(pos)
                    ln[w] = jnp.where(take[:, None], new_ln, ln[w])
                if e["event"]:
                    ev = take & (val >= s_pm)
                    ev_score = jnp.where(ev, val, ev_score)
                    if has_sid:
                        ev_sid = jnp.where(ev, s_sd, ev_sid)

            # --- advancing merge ----------------------------------------
            for e in adv_plan:
                adv = e["aq"] + e["at"]
                pv = prev[adv - 1]
                r = e["read"]
                if is_forward:
                    sh = e["aq"]
                    s_sc = jnp.roll(pv[0][r], sh).at[:sh].set(NEG) \
                        if sh else pv[0][r]
                    s_pm = jnp.roll(pv[1][r], sh).at[:sh].set(NEG) \
                        if sh else pv[1][r]
                    s_sd = (jnp.roll(pv[2][r], sh).at[:sh].set(0)
                            if sh else pv[2][r]) if has_sid else None
                    s_ln = ((jnp.roll(pv[3][r], sh, axis=0)
                             .at[:sh].set(0) if sh else pv[3][r])
                            if has_lanes else None)
                else:
                    sh = e["aq"]
                    s_sc = (jnp.roll(pv[0][r], -sh)
                            .at[Qp1 - sh:].set(NEG) if sh else pv[0][r])
                    s_pm = (jnp.roll(pv[1][r], -sh)
                            .at[Qp1 - sh:].set(NEG) if sh else pv[1][r])
                    s_sd = ((jnp.roll(pv[2][r], -sh)
                             .at[Qp1 - sh:].set(0) if sh else pv[2][r])
                            if has_sid else None)
                    s_ln = None
                accept(e, *eval_candidate(e, (s_sc, s_pm, s_sd, s_ln)))

            # --- span thaw + submit (forward, boundary models) ----------
            # runs BEFORE the silent sweep so silent exits from span
            # states (ner's `ner to match`, ref: scheduler.c:891-985
            # per-cell transition order) read the post-thaw value;
            # supported models have no silent WRITES into span states,
            # so nothing the sweep produces is consumed here
            new_span = span_carry
            xband_hit = jnp.zeros((), bool)
            # locus id per destination column: span interchange across
            # loci is impossible by construction (plan_bands span_window
            # join); the flag is a safety assertion
            seg_row = jnp.take(inputs["_seg"], jc)
            if is_forward and use_boundary and spans:
                new_span = []
                for spx, sp in enumerate(spans):
                    st = sp["state"]
                    (st_sc, st_pm, st_te, st_sg, st_ln,
                     cu_sc, cu_pm, cu_te, cu_sg, cu_ln) = span_carry[spx]
                    if sp["max_target"] == 0:
                        # query-only span: Scheduler_SpanData_submit
                        # only stores seeds when max_target != 0
                        # (scheduler.c:619-641), so these spans never
                        # freeze/thaw in the reference SDP at all —
                        # mirror the no-op
                        new_span.append(span_carry[spx])
                        continue
                    if sp["max_query"] > 0:
                        # joint span (ner, genome2genome): the
                        # reference carries ONE curr register through
                        # the lex-(t, q) walk, picking up the stored
                        # seed of lane q'' only at a thaw cell
                        # (q'', t') and carrying it along the row to
                        # later lanes (ref: Scheduler_SpanData_get_curr
                        # scheduler.c:567-645).  The diagonal-scan
                        # image of "next cell in the same row" is lane
                        # q-1 of the PREVIOUS diagonal, so the curr
                        # register becomes a per-lane plane advanced by
                        # a one-lane shift per diagonal — row restarts
                        # fall out of the lane-0 boundary (the q-window
                        # upper bound never binds: sdp_hybrid gates
                        # max_query >= qlen).  The one divergence from
                        # the serial register (a curr surviving ACROSS
                        # rows when the next row's thaw cells all sit
                        # above its entry lane) shows up as a locus
                        # score mismatch and falls back to the host
                        # path.  cu_* carry slots hold (sc, pm,
                        # q_entry->te reused, sg) of the rolling curr;
                        # cu lanes ride the span lane slots.
                        roll1 = lambda v, fill: jnp.concatenate(
                            [jnp.full((1,) + v.shape[1:], fill,
                                      v.dtype), v[:-1]], axis=0)
                        r_sc = roll1(cu_sc, NEG)
                        r_pm = roll1(cu_pm, 0)
                        r_te = roll1(cu_te, 0)
                        r_sg = roll1(cu_sg, 0)
                        r_ln = (roll1(cu_ln, 0) if has_lanes else cu_ln)
                        # expire by the target window at this cell
                        r_ok = (r_sc > NEG) & \
                            ((r_te + sp["max_target"]) >= abs_tv)
                        # pickup: thaw cells consult their own lane's
                        # stored seed; strictly-greater replaces
                        st_ok = (st_sc > NEG) & \
                            ((st_te + sp["max_target"]) >= abs_tv)
                        upd = thaw_row & st_ok & \
                            (~r_ok | (r_sc < st_sc))
                        r_sc = jnp.where(upd, st_sc,
                                         jnp.where(r_ok, r_sc, NEG))
                        r_pm = jnp.where(upd, st_pm, r_pm)
                        r_te = jnp.where(upd, st_te, r_te)
                        r_sg = jnp.where(upd, st_sg, r_sg)
                        if has_lanes:
                            r_ln = jnp.where(upd[:, None], st_ln, r_ln)
                        th = thaw_row & (r_sc > NEG) & (sc[st] < r_sc)
                        xband_hit |= jnp.any(th & (r_sg != seg_row))
                        pre_sc, pre_pm = sc[st], pm[st]
                        pre_ln = ln[st] if has_lanes else None
                        sc[st] = jnp.where(th, r_sc, sc[st])
                        pm[st] = jnp.where(th, r_pm, pm[st])
                        if has_lanes:
                            ln[st] = jnp.where(th[:, None], r_ln,
                                               ln[st])
                        cu_sc, cu_pm, cu_te, cu_sg = \
                            r_sc, r_pm, r_te, r_sg
                        if has_lanes:
                            cu_ln = r_ln
                        if sp["submit_post_thaw"]:
                            sub_sc, sub_pm = sc[st], pm[st]
                            sub_ln = ln[st] if has_lanes else None
                        else:
                            sub_sc, sub_pm = pre_sc, pre_pm
                            sub_ln = pre_ln
                        cand = cell_ok & (sub_sc >= 0)
                        rep = cand & (sub_sc >= st_sc)
                        st_sc = jnp.where(rep, sub_sc, st_sc)
                        st_pm = jnp.where(rep, sub_pm, st_pm)
                        st_te = jnp.where(rep, abs_tv, st_te)
                        st_sg = jnp.where(rep, seg_row, st_sg)
                        if has_lanes:
                            st_ln = jnp.where(rep[:, None], sub_ln,
                                              st_ln)
                        new_span.append((st_sc, st_pm, st_te, st_sg,
                                         st_ln, cu_sc, cu_pm, cu_te,
                                         cu_sg, cu_ln))
                        continue
                    # expire stored at thaw cells (ref: _span_thaw)
                    in_w = (st_te + sp["max_target"]) >= abs_tv
                    expired = thaw_row & (st_sc > NEG) & ~in_w
                    st_sc = jnp.where(expired, NEG, st_sc)
                    # curr: expire by window, refresh from stored
                    cu_ok = (cu_sc > NEG) & \
                        ((cu_te + sp["max_target"]) >= abs_tv)
                    upd = thaw_row & (st_sc > NEG) & in_w & \
                        (~cu_ok | (cu_sc < st_sc))
                    cu_sc = jnp.where(thaw_row & ~cu_ok & ~upd, NEG,
                                      jnp.where(upd, st_sc, cu_sc))
                    cu_pm = jnp.where(upd, st_pm, cu_pm)
                    cu_te = jnp.where(upd, st_te, cu_te)
                    cu_sg = jnp.where(upd, st_sg, cu_sg)
                    if has_lanes:
                        cu_ln = jnp.where(upd[:, None], st_ln, cu_ln)
                    # thaw into the cell (strict <)
                    th = thaw_row & (cu_sc > NEG) & (sc[st] < cu_sc)
                    # a thaw accepting a seed frozen in another band
                    # means bands interact: per-band scores are no
                    # longer per-seed-band maxima -> host global path
                    xband_hit |= jnp.any(th & (cu_sg != seg_row))
                    pre_sc, pre_pm = sc[st], pm[st]
                    pre_ln = ln[st] if has_lanes else None
                    sc[st] = jnp.where(th, cu_sc, sc[st])
                    pm[st] = jnp.where(th, cu_pm, pm[st])
                    if has_lanes:
                        ln[st] = jnp.where(th[:, None], cu_ln, ln[st])
                    # submit (value at the loop's position: pre- or
                    # post-thaw per the static transition order)
                    if sp["submit_post_thaw"]:
                        sub_sc, sub_pm = sc[st], pm[st]
                        sub_ln = ln[st] if has_lanes else None
                    else:
                        sub_sc, sub_pm = pre_sc, pre_pm
                        sub_ln = pre_ln
                    cand = cell_ok & (sub_sc >= 0)
                    rep = cand & (sub_sc >= st_sc)
                    st_sc = jnp.where(rep, sub_sc, st_sc)
                    st_pm = jnp.where(rep, sub_pm, st_pm)
                    st_te = jnp.where(rep, abs_tv, st_te)
                    st_sg = jnp.where(rep, seg_row, st_sg)
                    if has_lanes:
                        st_ln = jnp.where(rep[:, None], sub_ln, st_ln)
                    new_span.append((st_sc, st_pm, st_te, st_sg, st_ln,
                                     cu_sc, cu_pm, cu_te, cu_sg, cu_ln))
                new_span = tuple(new_span)

            # --- silent sweep (reverse model order) ---------------------
            for e in silent_plan:
                r = e["read"]
                src = (sc[r], pm[r],
                       sd[r] if has_sid else None,
                       ln[r] if has_lanes else None)
                accept(e, *eval_candidate(e, src))

            # --- finalize: mask invalid cells ---------------------------
            for s in range(S):
                sc[s] = jnp.where(cell_ok, sc[s], NEG)

            # --- liveness, events, boundary ys --------------------------
            any_live = jnp.zeros(Qp1, bool)
            for s in range(S):
                any_live |= sc[s] > NEG
            edge = jnp.take(inputs["_edge"], jc) & cell_ok
            live = live | jnp.any(any_live & edge)

            if is_forward:
                seg = jnp.take(inputs["_seg"], jc)
                acc = dict(acc)
                acc["band_end"] = acc["band_end"].at[
                    jnp.where(ev_score > NEG, seg, n_seg_pad - 1)
                ].max(ev_score)
                ys = jnp.zeros((), jnp.uint32)
                if debug_planes:
                    ys = (ys, jnp.stack(sc))
            else:
                if track_sid:
                    acc = dict(acc)
                    acc["rev_start"] = acc["rev_start"].at[
                        jnp.where(ev_score > NEG, ev_sid, 0)
                    ].max(jnp.where(ev_score > NEG, ev_score, NEG))
                # boundary bits (ref: scheduler.c:965-1000)
                flag = sc[start_id] >= 0
                for sp in spans:
                    flag |= sc[sp["state"]] > 0
                flag &= cell_ok
                ys = _pack_bits(flag, n_words)
                if debug_planes:
                    ys = (ys, jnp.stack(sc))

            diag = (tuple(sc), tuple(pm),
                    tuple(sd) if has_sid else (),
                    tuple(ln) if has_lanes else ())
            prev = (diag,) + prev[:-1]
            return (prev, new_span, acc, live, xband | xband_hit), ys

        return step

    step_rev = make_step(False)
    step_fwd = make_step(True)

    def init_prev(has_sid, has_lanes):
        neg = jnp.full(Qp1, NEG, jnp.int32)
        zero = jnp.zeros(Qp1, jnp.int32)
        zl = jnp.zeros((Qp1, n_sh), jnp.int32)
        diag = (tuple(neg for _ in range(S)),
                tuple(neg for _ in range(S)),
                tuple(zero for _ in range(S)) if has_sid else (),
                tuple(zl for _ in range(S)) if has_lanes else ())
        return tuple(diag for _ in range(K))

    def init_span(has_lanes):
        if not (use_boundary and spans):
            return ()
        neg = jnp.full(Qp1, NEG, jnp.int32)
        zero = jnp.zeros(Qp1, jnp.int32)
        zl = jnp.zeros((Qp1, n_sh), jnp.int32)
        return tuple((neg, zero, zero, zero, zl if has_lanes else None,
                      neg, zero, zero, zero, zl if has_lanes else None)
                     for _ in spans)

    def run(inputs):
        # G diagonals fold into each scan step, amortizing the per-step
        # loop overhead (the wavefront engine's unroll)
        G = fold
        Dg = ((Dp + G - 1) // G) * G
        d_seq = jnp.arange(Dg, dtype=jnp.int32)
        if G > 1:
            d_seq = d_seq.reshape(Dg // G, G)
        acc0 = {"band_end": jnp.full(n_seg_pad, NEG, jnp.int32)}
        if track_sid:
            acc0["rev_start"] = jnp.full(n_seed_pad, NEG, jnp.int32)
        dummy_inj = (jnp.zeros((Dg // G, G), jnp.uint32) if G > 1
                     else jnp.zeros(Dg, jnp.uint32))

        def group(step_fn, backwards=False):
            if G == 1:
                def one(carry, xs):
                    d, inj = xs
                    return step_fn(carry, (d, inj, inputs))
                return one

            def many(carry, xs):
                ds, injs = xs
                order = range(G - 1, -1, -1) if backwards else range(G)
                ys = [None] * G
                for g in order:
                    carry, ys[g] = step_fn(carry,
                                           (ds[g], injs[g], inputs))
                return carry, jax.tree_util.tree_map(
                    lambda *a: jnp.stack(a), *ys)
            return many

        carry0 = (init_prev(track_sid, False), (), acc0,
                  jnp.zeros((), bool), jnp.zeros((), bool))
        (prev, _sp, acc, live_r, _xb), ys = lax.scan(
            group(step_rev, backwards=True), carry0, (d_seq, dummy_inj),
            reverse=True)
        if debug_planes:
            ys, rev_planes = ys
            if G > 1:
                rev_planes = rev_planes.reshape(
                    (Dg,) + rev_planes.shape[2:])

        inj_xs = ys if use_boundary else dummy_inj
        carry1 = (init_prev(False, n_sh > 0), init_span(n_sh > 0), acc,
                  jnp.zeros((), bool), jnp.zeros((), bool))
        (prev, _sp, acc, live_f, xband), fys = lax.scan(
            group(step_fwd), carry1, (d_seq, inj_xs))
        if debug_planes and G > 1:
            fys = jax.tree_util.tree_map(
                lambda a: a.reshape((Dg,) + a.shape[2:]), fys)

        out = {"band_end": acc["band_end"], "live": live_r | live_f,
               "xband": xband}
        if debug_planes:
            out["rev_planes"] = rev_planes
            out["fwd_planes"] = fys[1]
            out["boundary_bits"] = ys
        if track_sid:
            out["start_scores"] = acc["rev_start"]
        return out

    return run


_CACHE: dict = {}


def get_fn(model: Model, Qp: int, Wp: int, kinds: tuple,
           use_boundary: bool, n_seed_pad: int, n_seg_pad: int,
           dropoff: int, batched: bool = False):
    from ..model.ir import model_fingerprint
    key = (model_fingerprint(model), Qp, Wp, kinds, use_boundary, n_seed_pad,
           n_seg_pad, dropoff, batched)
    if key not in _CACHE:
        fn = build_pass(model, Qp, Wp, kinds, use_boundary,
                        n_seed_pad, n_seg_pad, dropoff)
        if batched:
            fn = jax.vmap(fn)
        _CACHE[key] = jax.jit(fn)
    return _CACHE[key]
