"""JAX anti-diagonal wavefront DP engine.

The JAX replacement for the reference's generated-C Viterbi kernels
(ref: src/c4/viterbi.c:869-1758): the model IR is *traced* into a jitted
`lax.scan` over anti-diagonals d = i + j.  Within a diagonal every cell is
independent (advancing transitions read earlier diagonals; silent (0,0)
transitions are applied in the model's topologically-sorted order within the
step), so each step is pure vector work over the query axis, batchable
with `vmap` over padded sequence-pair batches.

Parity: integer int32 scores, transition evaluation in model order with
strictly-greater replacement (first max wins), end-cell preference
(score desc, target_pos asc, query_pos asc) — reproducing the reference's
(j, i)-lexicographic first-max tie-breaking (ref: viterbi.c:766-800,
SURVEY.md §8.2).

Modes:
- score:  best score.
- region: score + end point + region-start point (extra carried lanes),
  the analogue of the reference's reduced-space FIND_REGION
  (ref: src/c4/viterbi.h:104-109).

Calc grids are materialized per pair on host (NumPy) and *skewed* into
diagonal-major [D, Q+1] arrays fed to the scan as `xs`, so the inner loop
does no gathers for grid scores.  Shadow-dependent calcs (introns, split
codons) run their shadow_fn vectorized over the diagonal with xp=jnp.
"""
from __future__ import annotations

from functools import partial
from typing import Any

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..model.ir import (IMPOSSIBLY_LOW_SCORE, IMPOSSIBLY_HIGH_SCORE,
                        Model, Protect, Scope)
from .region import Region
from .reference import DPResult

NEG = IMPOSSIBLY_LOW_SCORE


# ---------------------------------------------------------------------------
# input preparation (host side, NumPy)
# ---------------------------------------------------------------------------

def _grid_key(model: Model, t) -> str:
    return f"g{model.calcs.index(t.calc)}_{t.advance_query}_{t.advance_target}"


def prepare_inputs(model: Model, region: Region, data,
                   subopt=None, pad_to=None) -> tuple[dict[str, Any], tuple]:
    """Materialize per-pair arrays in compact forms: factored match calcs
    ship O(Q+T) index vectors + a small table; 1-D calcs ship vectors; only
    genuinely 2-D grids ship whole planes (skewed on device).  Returns
    (inputs, kinds) where kinds is the static classification used to trace
    the engine (part of the jit cache key).

    subopt: optional SubOpt mask; blocked cells ship as a boolean plane so
    re-running with a grown mask reuses the jit cache."""
    Q, T = region.query_length, region.target_length
    Qp, Tp = pad_to if pad_to is not None else (Q, T)
    assert Qp >= Q and Tp >= T
    i_idx = np.arange(Q + 1)
    inputs: dict[str, Any] = {}
    kinds: dict[str, str] = {}
    # blocked-cell plane, addressed by DESTINATION cell
    # (ref: viterbi.c:701-704 SubOpt blocking of match transitions);
    # omitted entirely when empty and bit-packed otherwise to keep
    # host->device transfer tiny
    blocked = None if subopt is None else subopt.blocked_grid(region)
    if blocked is not None and blocked.any():
        inputs["_blocked"] = np.packbits(blocked, axis=1)
        kinds["_blocked"] = "blocked"
    done = set()
    for t in model.transitions:
        if t.calc is None:
            continue
        key = _grid_key(model, t)
        if key in done:
            continue
        done.add(key)
        aq, at = t.advance_query, t.advance_target
        si = np.clip(i_idx - aq, 0, Q)
        if t.calc.factored_fn is not None:
            f = t.calc.factored_fn(region, data)
            inputs[key] = {
                "q_idx_s": f["q_idx"][si].astype(np.int32),
                "t_idx": f["t_idx"].astype(np.int32),
                "table": f["table"].astype(np.int32),
                "q_override_s": f.get(
                    "q_override",
                    np.zeros(Q + 1, np.int32))[si].astype(np.int32),
            }
            kinds[key] = "factored"
            continue
        g = np.asarray(t.calc.materialize(region, data))
        if g.ndim == 0:
            inputs[key] = g.astype(np.int32)
            kinds[key] = "scalar"
            continue
        qdep = g.shape[0] > 1
        tdep = g.ndim > 1 and g.shape[1] > 1
        if qdep and not tdep:
            v = g[:, 0] if g.ndim > 1 else g
            inputs[key] = v[si].astype(np.int32)          # [Q+1]
            kinds[key] = "qvec"
        elif tdep and not qdep:
            v = g[0] if g.ndim > 1 else g
            inputs[key] = v.astype(np.int32)              # [T+1]
            kinds[key] = "tvec"
        else:
            inputs[key] = g.astype(np.int32)              # [Q+1, T+1]
            kinds[key] = "grid2d"
    for c in model.calcs:
        if c.shadow_inputs_fn is not None:
            inputs[f"sh{model.calcs.index(c)}"] = c.shadow_inputs_fn(region,
                                                                     data)
    inputs["_qstart"] = np.int32(region.query_start)
    inputs["_tstart"] = np.int32(region.target_start)
    inputs["_qlen"] = np.int32(Q)
    inputs["_tlen"] = np.int32(T)
    if pad_to is not None:
        inputs = _pad_inputs(inputs, kinds, Q, T, Qp, Tp)
    return inputs, tuple(sorted(kinds.items()))


def _pad_inputs(inputs, kinds, Q, T, Qp, Tp):
    """Pad per-pair arrays to a bucket shape (catch-all submat index 24
    for factored vectors; zeros elsewhere)."""
    out = {}
    for k, v in inputs.items():
        kind = kinds.get(k)
        if kind == "factored":
            out[k] = {
                "q_idx_s": np.pad(v["q_idx_s"], (0, Qp - Q),
                                  constant_values=24),
                "t_idx": np.pad(v["t_idx"], (0, Tp - T),
                                constant_values=24),
                "table": v["table"],
                "q_override_s": np.pad(v["q_override_s"], (0, Qp - Q)),
            }
        elif kind == "qvec":
            out[k] = np.pad(v, (0, Qp - Q))
        elif kind == "tvec":
            out[k] = np.pad(v, (0, Tp - T))
        elif kind == "grid2d":
            out[k] = np.pad(v, ((0, Qp - Q), (0, Tp - T)))
        elif kind == "blocked":
            grid = np.unpackbits(v, axis=1)[:, :T + 1]
            grid = np.pad(grid, ((0, Qp - Q), (0, Tp - T)))
            out[k] = np.packbits(grid, axis=1)
        else:
            out[k] = v
    return out


# ---------------------------------------------------------------------------
# traced engine
# ---------------------------------------------------------------------------

def _scope_mask_start(scope: Scope, si, sj):
    if scope == Scope.ANYWHERE:
        return jnp.ones_like(si, dtype=bool)
    if scope == Scope.EDGE:
        return (si == 0) | (sj == 0)
    if scope == Scope.QUERY:
        return si == 0
    if scope == Scope.TARGET:
        return sj == 0
    return (si == 0) & (sj == 0)


def _scope_mask_end(scope: Scope, i, j, qlen, tlen):
    if scope == Scope.ANYWHERE:
        return jnp.ones_like(i, dtype=bool)
    if scope == Scope.EDGE:
        return (i == qlen) | (j == tlen)
    if scope == Scope.QUERY:
        return i == qlen
    if scope == Scope.TARGET:
        return j == tlen
    return (i == qlen) & (j == tlen)


def build_wavefront(model: Model, Q: int, T: int, mode: str = "score",
                    kinds: tuple = (), unroll: int = 0):
    """Trace the model into a jittable function of the prepared inputs.

    Returns fn(inputs) -> dict with 'score', 'query_end', 'target_end' and
    (mode == 'region') 'query_start', 'target_start'.  Cache per (model
    identity, Q, T, mode) — the analogue of the reference bootstrapper's
    compiled-function archive (ref: src/model/bootstrapper.c:412-428).
    `unroll` diagonals fold into each scan step (0: the platform's
    value, device.wavefront_unroll).
    """
    if not unroll:
        from .. import device
        unroll = device.wavefront_unroll()
    assert not model.is_open
    want_region = mode in ("region", "path")
    want_path = mode == "path"
    S = len(model.states)
    n_shadow = model.total_shadow_designations
    L = n_shadow + (2 if want_region else 0)
    rs_q, rs_t = n_shadow, n_shadow + 1
    start_state = model.start_state.state
    end_state = model.end_state.state
    D = Q + T + 1
    K = max(max((t.advance_query + t.advance_target
                 for t in model.transitions), default=1), 1)

    # static per-transition plan
    plan = []
    for t in model.transitions:
        if t.input is end_state or t.output is start_state:
            continue
        shadow_starts = model.src_shadows(t.input)
        plan.append(dict(
            t=t,
            plan_id=len(plan),
            key=_grid_key(model, t) if t.calc is not None else None,
            shkey=(f"sh{model.calcs.index(t.calc)}"
                   if t.calc is not None and t.calc.shadow_fn is not None
                   else None),
            start_lanes=[(sh.designation, sh.start) for sh in shadow_starts],
            dst_shadows=[(sh.name, sh.designation) for sh in t.dst_shadows],
        ))

    i_vec = np.arange(Q + 1, dtype=np.int32)
    kind_map = dict(kinds)

    def step(carry, xs):
        # carry: prev = tuple of K diagonals (prev[k] = diagonal d-1-k),
        # each a tuple over states of (score [Q+1], lanes [Q+1, L]).
        # Per-state vectors keep every update O(Q) and make the diagonal
        # rotation a zero-copy tuple rebind.
        prev, best = carry
        d, grid_rows = xs
        i = jnp.asarray(i_vec)
        j = d - i
        qlen = grid_rows["_qlen"]
        tlen = grid_rows["_tlen"]
        cell_ok = (j >= 0) & (j <= tlen) & (i <= qlen)
        scores = [None] * S
        lanes_c = [None] * S
        is_set = [None] * S
        tb_c = ([jnp.zeros((Q + 1,), jnp.uint8) for _ in range(S)]
                if want_path else None)
        zero_lanes = jnp.zeros((Q + 1, L), jnp.int32)
        neg_vec = jnp.full((Q + 1,), NEG, jnp.int32)

        for p in plan:
            t = p["t"]
            aq, at = t.advance_query, t.advance_target
            adv = aq + at
            si, sj = i - aq, j - at
            src_ok = (si >= 0) & (sj >= 0) & cell_ok
            inp, out = t.input, t.output
            if inp is start_state:
                src_ok = src_ok & _scope_mask_start(
                    model.start_state.scope, si, sj)
                base = jnp.zeros(Q + 1, dtype=jnp.int32)
                src_lanes = zero_lanes
            else:
                if adv == 0:
                    if scores[inp.id] is None:
                        continue  # statically unreachable this cell
                    src_scores = jnp.where(is_set[inp.id],
                                           scores[inp.id], NEG)
                    src_l = lanes_c[inp.id]
                else:
                    src_scores, src_l = prev[adv - 1][inp.id]
                if aq > 0:
                    src_scores = jnp.roll(src_scores, aq).at[:aq].set(NEG)
                    src_l = jnp.roll(src_l, aq, axis=0).at[:aq].set(0)
                base = src_scores
                src_lanes = src_l
            if out is end_state:
                src_ok = src_ok & _scope_mask_end(model.end_state.scope,
                                                  i, j, qlen, tlen)
            if t.is_match and "_blocked" in kind_map:
                src_ok = src_ok & ~grid_rows["_blocked"]
            # calc score at source position (form picked statically)
            if p["key"] is None:
                calc = jnp.zeros((), dtype=jnp.int32)
            else:
                kind = kind_map.get(p["key"], "grid2d")
                v = grid_rows[p["key"]]
                if kind == "factored":
                    tj = jnp.take(v["t_idx"], jnp.clip(sj, 0, T))
                    gathered = v["table"][v["q_idx_s"], tj]
                    calc = jnp.where(v["q_override_s"] != 0,
                                     v["q_override_s"], gathered)
                elif kind == "tvec":
                    calc = jnp.take(v, jnp.clip(sj, 0, T))
                else:  # scalar, qvec (const per step) or skewed grid2d row
                    calc = v
            if p["shkey"] is not None:
                svals = {name: src_lanes[:, desig]
                         for name, desig in p["dst_shadows"]}
                calc = t.calc.shadow_fn(
                    jnp, calc, svals, grid_rows[p["shkey"]],
                    si + grid_rows["_qstart"], sj + grid_rows["_tstart"])
            val = base + calc
            if t.calc is not None:
                if t.calc.protect & Protect.UNDERFLOW:
                    val = jnp.maximum(val, NEG)
                if t.calc.protect & Protect.OVERFLOW:
                    val = jnp.minimum(val, IMPOSSIBLY_HIGH_SCORE)
            val = jnp.maximum(val, NEG)
            if inp is start_state:
                val = jnp.where(src_ok, val, NEG)
            else:
                val = jnp.where(src_ok & (base > NEG), val, NEG)
            cur = scores[out.id] if scores[out.id] is not None else neg_vec
            cur_set = (is_set[out.id] if is_set[out.id] is not None
                       else jnp.zeros(Q + 1, bool))
            take = (val > jnp.where(cur_set, cur, NEG)) & src_ok
            scores[out.id] = jnp.where(take, val, cur)
            is_set[out.id] = cur_set | take
            if want_path:
                tb_c[out.id] = jnp.where(
                    take, jnp.uint8(p["plan_id"] + 1), tb_c[out.id])
            if L:
                new_lanes = src_lanes
                for desig, kind in p["start_lanes"]:
                    pos = (si + grid_rows["_qstart"]
                           if kind == "query_pos"
                           else sj + grid_rows["_tstart"])
                    new_lanes = new_lanes.at[:, desig].set(pos)
                if inp is start_state and want_region:
                    new_lanes = new_lanes.at[:, rs_q].set(si)
                    new_lanes = new_lanes.at[:, rs_t].set(sj)
                old = (lanes_c[out.id] if lanes_c[out.id] is not None
                       else zero_lanes)
                lanes_c[out.id] = jnp.where(take[:, None], new_lanes, old)
            elif lanes_c[out.id] is None:
                lanes_c[out.id] = zero_lanes

        # end registration with (score desc, j asc, i asc) preference
        if scores[end_state.id] is not None:
            end_scores = jnp.where(is_set[end_state.id] & cell_ok,
                                   scores[end_state.id], NEG)
        else:
            end_scores = neg_vec
        m = jnp.max(end_scores)
        ix = jnp.argmax(jnp.where(end_scores == m, i, -1))
        c_score = end_scores[ix]
        c_i = i[ix]
        c_j = d - c_i
        if want_region and lanes_c[end_state.id] is not None:
            c_qs = lanes_c[end_state.id][ix, rs_q]
            c_ts = lanes_c[end_state.id][ix, rs_t]
        else:
            c_qs = jnp.int32(0)
            c_ts = jnp.int32(0)
        best_score, b_i, b_j, b_qs, b_ts = best
        better = (c_score > best_score) | \
                 ((c_score == best_score) &
                  ((c_j < b_j) | ((c_j == b_j) & (c_i < b_i))))
        best = (jnp.where(better, c_score, best_score),
                jnp.where(better, c_i, b_i),
                jnp.where(better, c_j, b_j),
                jnp.where(better, c_qs, b_qs) if want_region else b_qs,
                jnp.where(better, c_ts, b_ts) if want_region else b_ts)

        # assemble the new diagonal; rotation is a tuple rebind (no copy)
        cur_diag = []
        for s in range(S):
            if scores[s] is None:
                cur_diag.append((neg_vec, zero_lanes))
            else:
                sc = jnp.where(is_set[s], scores[s], NEG)
                ln = (jnp.where(is_set[s][:, None], lanes_c[s], 0)
                      if lanes_c[s] is not None else zero_lanes)
                cur_diag.append((sc, ln))
        prev = (tuple(cur_diag),) + prev[:-1]
        ys = (jnp.stack(tb_c, axis=1) if want_path
              else jnp.zeros((), jnp.uint8))
        return (prev, best), ys

    # advances per grid key, for the on-device skew of 2-D planes
    adv_of_key = {}
    for t in model.transitions:
        if t.calc is not None:
            adv_of_key[_grid_key(model, t)] = (t.advance_query,
                                               t.advance_target)

    def _skew(plane, aq, at, fill):
        """[Q+1, T+1] -> diagonal-major [D, Q+1] on device (one gather)."""
        d_col = jnp.arange(D, dtype=jnp.int32)[:, None]
        i_row = jnp.asarray(i_vec)[None, :]
        si = jnp.clip(i_row - aq, 0, Q)
        sj = d_col - i_row - at
        ok = (sj >= 0) & (sj <= T) & (i_row - aq >= 0)
        vals = plane[jnp.broadcast_to(si, (D, Q + 1)),
                     jnp.clip(sj, 0, T)]
        return jnp.where(ok, vals, fill)

    def run(inputs):
        # 2-D planes (grid2d calcs, blocked mask) skew on device and feed
        # the scan as xs; everything else broadcasts as a constant
        G = max(1, unroll)
        Dp = ((D + G - 1) // G) * G
        xs_rows = {}
        const_rows = {}
        for k, v in inputs.items():
            if k == "_blocked":
                # bit-packed [Q+1, ceil((T+1)/8)]: unpack while skewing
                packed = jnp.asarray(v)
                d_col = jnp.arange(D, dtype=jnp.int32)[:, None]
                i_row = jnp.asarray(i_vec)[None, :]
                sj = d_col - i_row
                ok = (sj >= 0) & (sj <= T)
                sjc = jnp.clip(sj, 0, T)
                byte = packed[jnp.broadcast_to(i_row, (D, Q + 1)),
                              sjc >> 3]
                bit = (byte >> (7 - (sjc & 7).astype(jnp.uint8))) & 1
                xs_rows[k] = (bit != 0) & ok
            elif kind_map.get(k) == "grid2d":
                aq, at = adv_of_key[k]
                xs_rows[k] = _skew(jnp.asarray(v, jnp.int32), aq, at, 0)
            else:
                const_rows[k] = v
        neg_vec = jnp.full((Q + 1,), NEG, jnp.int32)
        zero_lanes = jnp.zeros((Q + 1, L), jnp.int32)
        diag0 = tuple((neg_vec, zero_lanes) for _ in range(S))
        prev0 = tuple(diag0 for _ in range(K))
        best0 = (jnp.int32(NEG), jnp.int32(0), jnp.int32(0),
                 jnp.int32(0), jnp.int32(0))
        # pad xs planes to a multiple of G and group G diagonals per step
        if G > 1:
            xs_rows = {k: jnp.concatenate(
                [a, jnp.zeros((Dp - D,) + a.shape[1:], a.dtype)]
            ).reshape((Dp // G, G) + a.shape[1:])
                for k, a in xs_rows.items()}
            d_seq = jnp.arange(Dp, dtype=jnp.int32).reshape(Dp // G, G)
        else:
            d_seq = jnp.arange(D, dtype=jnp.int32)

        def scan_step(carry, xs):
            d, rows = xs
            if G > 1:
                ys = []
                for g in range(G):
                    merged = dict(const_rows)
                    merged.update({k: a[g] for k, a in rows.items()})
                    carry, y = step(carry, (d[g], merged))
                    ys.append(y)
                return carry, (jnp.stack(ys) if want_path
                               else jnp.zeros((), jnp.uint8))
            merged = dict(const_rows)
            merged.update(rows)
            return step(carry, (d, merged))

        (prev, best), tbs = lax.scan(scan_step, (prev0, best0),
                                     (d_seq, xs_rows))
        if want_path and G > 1:
            tbs = tbs.reshape((Dp,) + tbs.shape[2:])[:D]
        score, bi, bj, bqs, bts = best
        out = {"score": score, "query_end": bi, "target_end": bj}
        if want_region:
            out["query_start"] = bqs
            out["target_start"] = bts
        if want_path:
            out["tb"] = tbs
        return out

    def split_inputs(inputs):
        """Host-side split into (xs planes [D, Q+1], const rows) — used by
        the checkpointed driver."""
        xs_rows = {}
        const_rows = {}
        for k, v in inputs.items():
            if k == "_blocked":
                packed = jnp.asarray(v)
                d_col = jnp.arange(D, dtype=jnp.int32)[:, None]
                i_row = jnp.asarray(i_vec)[None, :]
                sj = d_col - i_row
                ok = (sj >= 0) & (sj <= T)
                sjc = jnp.clip(sj, 0, T)
                byte = packed[jnp.broadcast_to(i_row, (D, Q + 1)),
                              sjc >> 3]
                bit = (byte >> (7 - (sjc & 7).astype(jnp.uint8))) & 1
                xs_rows[k] = (bit != 0) & ok
            elif kind_map.get(k) == "grid2d":
                aq, at = adv_of_key[k]
                xs_rows[k] = _skew(jnp.asarray(v, jnp.int32), aq, at, 0)
            else:
                const_rows[k] = v
        return xs_rows, const_rows

    def init_carry():
        neg_vec = jnp.full((Q + 1,), NEG, jnp.int32)
        zero_lanes = jnp.zeros((Q + 1, L), jnp.int32)
        diag0 = tuple((neg_vec, zero_lanes) for _ in range(S))
        prev0 = tuple(diag0 for _ in range(K))
        best0 = (jnp.int32(NEG), jnp.int32(0), jnp.int32(0),
                 jnp.int32(0), jnp.int32(0))
        return (prev0, best0)

    run.step = step
    run.split_inputs = split_inputs
    run.init_carry = init_carry
    return run


_CACHE: dict = {}


def _get_fn(model: Model, Q: int, T: int, mode: str, kinds: tuple):
    from ..model.ir import model_fingerprint
    key = (model_fingerprint(model), Q, T, mode, kinds)
    if key not in _CACHE:
        _CACHE[key] = jax.jit(build_wavefront(model, Q, T, mode, kinds))
    return _CACHE[key]


def _put(inputs, device=None):
    """Batched host->device transfer: one device_put for the whole pytree
    (jit's per-leaf argument conversion costs one transfer per leaf)."""
    if device is None:
        return jax.device_put(inputs)
    return jax.device_put(inputs, device)


def find_score(model: Model, region: Region, data, subopt=None,
               device=None) -> int:
    inputs, kinds = prepare_inputs(model, region, data, subopt)
    fn = _get_fn(model, region.query_length, region.target_length,
                 "score", kinds)
    return int(fn(_put(inputs, device))["score"])


def find_region(model: Model, region: Region, data,
                subopt=None, device=None) -> DPResult:
    inputs, kinds = prepare_inputs(model, region, data, subopt)
    fn = _get_fn(model, region.query_length, region.target_length,
                 "region", kinds)
    out = jax.tree_util.tree_map(int, fn(_put(inputs, device)))
    return DPResult(score=out["score"],
                    query_end=out["query_end"],
                    target_end=out["target_end"],
                    query_start=out["query_start"],
                    target_start=out["target_start"])


def find_path(model: Model, region: Region, data,
              subopt=None, device=None) -> DPResult:
    """Full path: device-side winning-transition planes + host walk-back.

    The traceback cube is [D, Q+1, S] uint8 (plan ids), the device-memory
    analogue of the reference's FIND_PATH traceback matrix
    (ref: viterbi.c:458-460); the reference's checkpointed recursion
    (--dpmemory) is the fallback for regions whose cube exceeds memory —
    handled by the caller re-running on subregions.
    """
    inputs, kinds = prepare_inputs(model, region, data, subopt)
    fn = _get_fn(model, region.query_length, region.target_length,
                 "path", kinds)
    out = fn(_put(inputs, device))
    tb = np.asarray(out["tb"])
    res = DPResult(score=int(out["score"]),
                   query_end=int(out["query_end"]),
                   target_end=int(out["target_end"]),
                   query_start=int(out["query_start"]),
                   target_start=int(out["target_start"]))
    # walk back (ref: Viterbi_Data_create_Alignment, viterbi.c:342-392)
    plan_ts = [t for t in model.transitions
               if t.input is not model.end_state.state
               and t.output is not model.start_state.state]
    start_state = model.start_state.state
    end_state = model.end_state.state
    i, j = res.query_end, res.target_end
    state = end_state
    path = []
    while True:
        tid = tb[i + j, i, state.id]
        if tid == 0:
            break
        t = plan_ts[tid - 1]
        path.append(t)
        i -= t.advance_query
        j -= t.advance_target
        if t.input is start_state:
            break
        state = t.input
    path.reverse()
    res.path = path
    res.query_start, res.target_start = i, j
    return res


# ---------------------------------------------------------------------------
# batched pairs (the production throughput path)
# ---------------------------------------------------------------------------

def _bucket_ladder(max_n: int = 1 << 24, step: int = 256,
                   ratio: float = 1.25) -> list[int]:
    """Geometric ladder of padded lengths: each rung is at most `ratio`
    above the previous, so padding wastes <= ratio while the number of
    distinct compiled kernel shapes stays logarithmic (each fresh
    (Qp, Tp) bucket costs a compile — a linear 256-step grid causes a
    compile storm on real locus workloads)."""
    rungs = [step]
    while rungs[-1] < max_n:
        nxt = max(rungs[-1] + step,
                  ((int(rungs[-1] * ratio) + step - 1) // step) * step)
        rungs.append(nxt)
    return rungs


_LADDER = _bucket_ladder()


def _bucket(n: int, step: int = 256) -> int:
    for r in _LADDER:
        if n <= r:
            return r
    return _LADDER[-1]


def _get_batched_fn(model: Model, Qp: int, Tp: int, mode: str,
                    kinds: tuple):
    from ..model.ir import model_fingerprint
    key = (model_fingerprint(model), Qp, Tp, mode, kinds, "batched")
    if key not in _CACHE:
        _CACHE[key] = jax.jit(
            jax.vmap(build_wavefront(model, Qp, Tp, mode, kinds)))
    return _CACHE[key]


def find_region_batched(model: Model, jobs: list,
                        subopt=None) -> list[DPResult]:
    """Score a batch of (region, data) pairs in bucketed, vmapped calls —
    the batched replacement for the reference's per-comparison thread pool
    (ref: jobqueue.c; disabled in the fork for races, SURVEY.md §2.13).
    """
    out: list[DPResult] = [None] * len(jobs)
    buckets: dict = {}
    for n, (region, data) in enumerate(jobs):
        Qp = _bucket(region.query_length)
        Tp = _bucket(region.target_length)
        inputs, kinds = prepare_inputs(model, region, data,
                                       subopt=subopt,
                                       pad_to=(Qp, Tp))
        buckets.setdefault((Qp, Tp, kinds), []).append((n, inputs))
    for (Qp, Tp, kinds), items in buckets.items():
        fn = _get_batched_fn(model, Qp, Tp, "region", kinds)
        stacked = jax.tree_util.tree_map(
            lambda *xs: np.stack(xs), *[inp for _, inp in items])
        res = fn(_put(stacked))
        res = jax.tree_util.tree_map(np.asarray, res)
        for b, (n, _) in enumerate(items):
            out[n] = DPResult(
                score=int(res["score"][b]),
                query_end=int(res["query_end"][b]),
                target_end=int(res["target_end"][b]),
                query_start=int(res["query_start"][b]),
                target_start=int(res["target_start"][b]))
    return out


# ---------------------------------------------------------------------------
# checkpointed traceback (the reference's --dpmemory bound,
# ref: viterbi.c:128-152, 537-633 Hughey checkpointing)
# ---------------------------------------------------------------------------

def find_path_checkpointed(model: Model, region: Region, data,
                           subopt=None,
                           budget_bytes: int = 32 << 20) -> DPResult:
    """Full-path DP under a traceback-memory budget: forward pass over
    diagonal segments saving one carry checkpoint per segment, then a
    backward walk re-running only the segments the path crosses and
    materializing one segment's traceback planes at a time.
    """
    Q, T = region.query_length, region.target_length
    D = Q + T + 1
    S = len(model.states)
    inputs, kinds = prepare_inputs(model, region, data, subopt)
    # full cube fits: one pass
    if D * (Q + 1) * S <= budget_bytes:
        return find_path(model, region, data, subopt)
    # segment length bounded by per-segment tb plane memory
    C = max(16, min(D, budget_bytes // max((Q + 1) * S, 1)))
    n_seg = (D + C - 1) // C

    engine = build_wavefront(model, Q, T, "path", kinds)
    step = engine.step
    xs_rows, const_rows = engine.split_inputs(inputs)

    def seg(carry, d0, seg_xs, consts, collect_tb: bool):
        def scan_step(c, xs):
            d, rows = xs
            merged = dict(consts)
            merged.update(rows)
            return step(c, (d, merged))
        d_seq = d0 + jnp.arange(C, dtype=jnp.int32)
        (carry, ys) = lax.scan(scan_step, carry, (d_seq, seg_xs))
        return carry if not collect_tb else (carry, ys)

    fwd = jax.jit(lambda c, d0, xs, consts: seg(c, d0, xs, consts, False))
    bwd = jax.jit(lambda c, d0, xs, consts: seg(c, d0, xs, consts, True))

    def xs_slice(s0):
        lo = s0 * C
        return jax.tree_util.tree_map(
            lambda a: lax.dynamic_slice_in_dim(
                a, min(lo, a.shape[0] - C), C, axis=0), xs_rows)

    # pad xs planes to a multiple of C so slices are uniform
    pad = n_seg * C - D
    if pad:
        xs_rows = jax.tree_util.tree_map(
            lambda a: jnp.concatenate(
                [a, jnp.zeros((pad,) + a.shape[1:], a.dtype)]), xs_rows)

    checkpoints = []
    carry = engine.init_carry()
    for s0 in range(n_seg):
        checkpoints.append(carry)
        lo = s0 * C
        seg_xs = jax.tree_util.tree_map(
            lambda a: a[lo:lo + C], xs_rows)
        carry = fwd(carry, jnp.int32(lo), seg_xs, const_rows)
    prev, best = carry
    score, bi, bj, bqs, bts = [int(np.asarray(x)) for x in best]
    res = DPResult(score=score, query_end=bi, target_end=bj,
                   query_start=bqs, target_start=bts)

    # backward walk
    plan_ts = [t for t in model.transitions
               if t.input is not model.end_state.state
               and t.output is not model.start_state.state]
    start_state = model.start_state.state
    end_state = model.end_state.state
    i, j = bi, bj
    state = end_state
    path = []
    seg_cache: dict[int, np.ndarray] = {}

    def tb_for(d):
        s0 = d // C
        if s0 not in seg_cache:
            lo = s0 * C
            seg_xs = jax.tree_util.tree_map(
                lambda a: a[lo:lo + C], xs_rows)
            _, ys = bwd(checkpoints[s0], jnp.int32(lo), seg_xs,
                        const_rows)
            seg_cache[s0] = np.asarray(ys)
            # drop older cache entries to respect the budget
            for k in list(seg_cache):
                if k != s0:
                    del seg_cache[k]
        return seg_cache[s0][d - s0 * C]

    while True:
        d = i + j
        tid = tb_for(d)[i, state.id]
        if tid == 0:
            break
        t = plan_ts[tid - 1]
        path.append(t)
        i -= t.advance_query
        j -= t.advance_target
        if t.input is start_state:
            break
        state = t.input
    path.reverse()
    res.path = path
    res.query_start, res.target_start = i, j
    return res
