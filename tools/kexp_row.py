"""Row-scan band recurrence experiment (VERDICT r4 #7: "a different
recurrence formulation").

The anti-diagonal band scan's step count is W+Q+1 — driven by the
compressed band width — while each step fills only ~Q lanes.  For the
north-star protein2genome shape (Q~150 aa, W~160k band columns at
10 Mb genome scale) that loses to the host scheduler by a wide margin
(BASELINE.md).

This prototype measures the TRANSPOSED formulation on the same shape:
vectors along W (the huge axis), lax.scan over the Q rows, so the step
count is Q (~150) and every step is a full-width vector op.  The
recurrence is the protein2genome cost skeleton (score-only):

- codon match (advance 1,3): prev row shifted 3 columns + per-row
  submat gather over the target symbol lane;
- query gap / insert (1,0): prev row, same column;
- target gap / delete (0,3): within-row bounded chain — the dropoff
  budget caps a gap run at ~dropoff/|gapextend| columns, so the chain
  closes in ceil(log2(len)) doubling steps, not a full prefix scan;
- target intron span (enter (q,w0) -> exit (q,w1), same row):
  freeze = row vector of 5'ss entries, thaw = prefix max along W
  delayed by min_intron columns (log2(W) doubling steps), plus 3'ss
  exit scores.

Numbers decide whether a production row-scan engine can hit the
BASELINE.json 50x target for short-query genome scans; parity is NOT
the goal here (the production engine would keep the usual host
cross-check / HybridFallback safety net).

Usage: python tools/kexp_row.py [B] [Q] [W]
"""
from __future__ import annotations

import sys
import time
from functools import partial  # noqa: F401

import numpy as np

NEG = -987654321


def build_inputs(B, Q, W, seed=7):
    rng = np.random.default_rng(seed)
    # per-position symbol indices and a 24x64 codon-ish submat
    q_sym = rng.integers(0, 24, size=(B, Q), dtype=np.int32)
    t_sym = rng.integers(0, 64, size=(B, W), dtype=np.int32)
    table = rng.integers(-12, 10, size=(24, 64), dtype=np.int32)
    # splice score vectors (5' and 3'), mostly very negative
    s5 = np.where(rng.random((B, W)) < 0.01,
                  rng.integers(-12, 3, size=(B, W)),
                  -60).astype(np.int32)
    s3 = np.where(rng.random((B, W)) < 0.01,
                  rng.integers(-12, 3, size=(B, W)),
                  -60).astype(np.int32)
    return q_sym, t_sym, table, s5, s3


def make_fn(Q, W, gap_open=-12, gap_ext=-4, dropoff=50,
            min_intron=30, intron_open=-30):
    import jax
    import jax.numpy as jnp
    from jax import lax

    max_del = max(1, dropoff // -gap_ext)        # bounded gap run
    del_steps = int(np.ceil(np.log2(max_del))) + 1
    pre_steps = int(np.ceil(np.log2(max(W, 2))))

    def row_step(carry, xs, s5_row, s3_row):
        m_prev, i_prev = carry
        ms_row = xs
        # codon match from (q-1, w-3); insert (query gap) from (q-1, w)
        m_shift = jnp.concatenate(
            [jnp.full(3, NEG, jnp.int32), m_prev[:-3]])
        best_in = jnp.maximum(m_shift, i_prev + gap_ext)
        # intron: freeze at 5' sites from the incoming row value, thaw
        # as a delayed prefix max (same-row span), exit through 3'
        frozen = best_in + s5_row + intron_open
        pmax = frozen
        for k in range(pre_steps):
            sh = 1 << k
            pmax = jnp.maximum(pmax, jnp.concatenate(
                [jnp.full(sh, NEG, jnp.int32), pmax[:-sh]]))
        thaw = jnp.concatenate(
            [jnp.full(min_intron, NEG, jnp.int32), pmax[:-min_intron]])
        best_in = jnp.maximum(best_in, thaw + s3_row)
        # match emission
        m = best_in + ms_row
        # within-row bounded delete chain (advance 0,3)
        d = m + gap_open
        for k in range(del_steps):
            sh = 3 << k
            step = jnp.concatenate(
                [jnp.full(sh, NEG, jnp.int32), d[:-sh]]) + gap_ext * (1 << k)
            d = jnp.maximum(d, step)
        m = jnp.maximum(m, d + 0)      # close gap back into match
        i_new = jnp.maximum(m + gap_open, i_prev + gap_ext)
        return (m, i_new), jnp.max(m)

    def one_pair(q_sym, t_sym, table, s5, s3):
        # per-row match-score vectors: one gather per row (the real
        # engine's factored submat lookup)
        ms = table[q_sym][:, t_sym]          # [Q, W]
        init = (jnp.full(W, 0, jnp.int32), jnp.full(W, NEG, jnp.int32))
        (_m, _i), row_best = lax.scan(
            partial(row_step, s5_row=s5, s3_row=s3), init, ms)
        return jnp.max(row_best)

    import jax
    return jax.jit(jax.vmap(one_pair, in_axes=(0, 0, None, 0, 0)))


def main(B=8, Q=152, W=163840):
    import jax
    q_sym, t_sym, table, s5, s3 = build_inputs(B, Q, W)
    fn = make_fn(Q, W)
    args = [jax.device_put(x) for x in (q_sym, t_sym, table, s5, s3)]
    t0 = time.perf_counter()
    out = np.asarray(fn(*args))
    compile_s = time.perf_counter() - t0
    reps = 5
    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = np.asarray(fn(*args))     # value fetch = sync
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    cells = B * Q * W
    print(f"row-scan kernel B={B} Q={Q} W={W}: compile {compile_s:.1f}s, "
          f"best {best*1e3:.2f} ms/batch = {best/B*1e3:.3f} ms/DP, "
          f"{cells/best/1e9:.2f} GCUPS, scores={out.tolist()[:4]}...")
    return best / B


if __name__ == "__main__":
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    Q = int(sys.argv[2]) if len(sys.argv) > 2 else 152
    W = int(sys.argv[3]) if len(sys.argv) > 3 else 163840
    main(B, Q, W)
