"""Multi-chip ungapped genome scanning.

A reformulation of exonerate's ungapped model at scale: the
best ungapped local alignment on each diagonal is a *maximum-subarray*
problem over that diagonal's match scores, and max-subarray combination is
an associative monoid (sum, best-prefix, best-suffix, best).  That makes
ungapped scanning:

- vectorizable: all diagonals of a (query x target-tile) block fold in one
  `lax.scan` over the query axis; each step is a contiguous
  dynamic-slice placement (no gathers) plus VPU-wide combines;
- shardable: chromosome-scale targets split into tiles across devices,
  each tile's per-diagonal monoid vector slots into the global diagonal
  axis at its tile offset and cross-device combination is a log-fold over
  the 'sp' mesh axis — the framework's long-context design (the role the
  reference fills with BSAM streaming + SparseCache paging,
  ref: src/hub/bsam.c, SURVEY.md §2.13).

Pair batches shard over 'dp' (the reference's cluster chunk flags,
ref: exonerate.1:177-204, realized as a mesh axis), and per-query bests
merge with an all-gather + top-k instead of external concatenation.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

NEG = jnp.int32(-1 << 30)


def monoid_identity(shape):
    z = jnp.zeros(shape, jnp.int32)
    return z, z, z, z


def monoid_single(v, present):
    """Singleton monoid element per lane; absent lanes are identity."""
    vp = jnp.maximum(v, 0)
    zero = jnp.zeros_like(v)
    return (jnp.where(present, v, zero),
            jnp.where(present, vp, zero),
            jnp.where(present, vp, zero),
            jnp.where(present, vp, zero))


def monoid_combine(a, b):
    asum, apre, asuf, abest = a
    bsum, bpre, bsuf, bbest = b
    return (asum + bsum,
            jnp.maximum(apre, asum + bpre),
            jnp.maximum(bsuf, bsum + asuf),
            jnp.maximum(jnp.maximum(abest, bbest), asuf + bpre))


def tile_diagonal_monoid(q_idx, t_idx, submat):
    """Fold one (query x target-tile) block into a monoid element per
    *local* diagonal.  Local diagonal axis g = j - i + (Q-1), size
    Q + Tt - 1 (padded to Q + Tt).  Row i of the block covers the
    contiguous band [Q-1-i, Q-1-i+Tt) — placed with one dynamic slice.
    """
    Q = q_idx.shape[0]
    Tt = t_idx.shape[0]
    nd = Q + Tt
    lanes = jnp.arange(nd)

    def step(carry, i):
        row = submat[q_idx[i]][t_idx]                     # [Tt]
        off = Q - 1 - i
        vals = lax.dynamic_update_slice(
            jnp.zeros((nd,), jnp.int32), row, (off,))
        present = (lanes >= off) & (lanes < off + Tt)
        return monoid_combine(carry, monoid_single(vals, present)), None

    out, _ = lax.scan(step, monoid_identity((nd,)), jnp.arange(Q))
    return out


def place_global(m_local, Q: int, n_diags: int, tile_start):
    """Slot a tile's local diagonal monoid vector into the global diagonal
    axis at its tile offset (global g = local g + tile_start)."""
    return tuple(
        lax.dynamic_update_slice(jnp.zeros((n_diags,), jnp.int32), x,
                                 (tile_start,))
        for x in m_local)


def _fold_tiles(q_idx, t_tiles, tile_starts, submat, n_diags, Q):
    def one_tile(carry, s):
        m = tile_diagonal_monoid(q_idx, t_tiles[s], submat)
        g = place_global(m, Q, n_diags, tile_starts[s])
        return monoid_combine(carry, g), None
    init = monoid_identity((n_diags,))
    m, _ = lax.scan(one_tile, init, jnp.arange(t_tiles.shape[0]))
    return m


def make_sharded_scan(mesh: Mesh, B: int, Q: int, T: int, S: int,
                      submat: np.ndarray, topk: int = 8):
    """Build the jitted multi-chip scan step over mesh axes ('dp', 'sp').

    Arguments to the returned fn:
      q_codes [B, Q] int32 (sharded over 'dp'),
      t_tiles [S, T//S] int32 (sharded over 'sp'),
      tile_starts [S] int32 (sharded over 'sp').
    Returns (best [B] per-pair best score, topk [topk] global best).
    """
    n_diags = Q + T
    sub = jnp.asarray(submat, jnp.int32)

    def step(q_codes, t_tiles, tile_starts):
        local = jax.vmap(
            lambda q: _fold_tiles(q, t_tiles, tile_starts, sub,
                                  n_diags, Q))(q_codes)
        # monoid all-reduce over the sequence axis
        gathered = [lax.all_gather(x, "sp", tiled=False) for x in local]
        nsp = gathered[0].shape[0]
        acc = tuple(g[0] for g in gathered)
        for k in range(1, nsp):
            acc = monoid_combine(acc, tuple(g[k] for g in gathered))
        best = acc[3].max(axis=-1)                        # [B_local]
        all_best = lax.all_gather(best, "dp", tiled=True)  # [B]
        top = lax.top_k(all_best, min(topk, B))[0]
        return best, top

    from jax.experimental.shard_map import shard_map
    smapped = shard_map(
        step, mesh=mesh,
        in_specs=(P("dp", None), P("sp", None), P("sp")),
        out_specs=(P("dp"), P(None)),
        check_rep=False)
    return jax.jit(smapped)


def single_device_scan(submat: np.ndarray):
    """Single-chip batched scan (bench): fn(q_codes [B,Q],
    t_tiles [S,Tt], tile_starts [S]) -> best [B]."""
    sub = jnp.asarray(submat, jnp.int32)

    @jax.jit
    def step(q_codes, t_tiles, tile_starts):
        B, Q = q_codes.shape
        S, Tt = t_tiles.shape
        n_diags = Q + S * Tt

        def one_pair(q_idx):
            m = _fold_tiles(q_idx, t_tiles, tile_starts, sub, n_diags, Q)
            return m[3].max()
        return jax.vmap(one_pair)(q_codes)

    return step
