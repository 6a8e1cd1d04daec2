"""Device-resident sharded word index (stage-4 serving prototype).

The reference serves whole-genome scans from an on-disk word index via
a TCP server (ref: src/program/exonerate-server.c, src/database/
index.h:55-147).  The device endgame keeps the `.esi` postings as
device arrays sharded over a mesh axis, and turns `get hsps` into a
collective lookup: every chip extracts the postings it owns for the
query's word ranges and the results merge with one psum over the mesh
(disjoint ownership makes addition a merge) — seed exchange rides ICI
instead of a socket (SURVEY.md §2.13 row 3).

Single-host prototype: exact parity with Index.lookup_word, tested on
the virtual CPU mesh; the same code lays out a pod slice by changing
the mesh.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .index import Index


class DeviceIndex:
    """Postings sharded over mesh[axis]; word table replicated."""

    def __init__(self, index: Index, mesh: Mesh, axis: str = "dp"):
        self.index = index
        self.mesh = mesh
        self.axis = axis
        n_dev = mesh.devices.size
        n_post = len(index.post_seq)
        pad = (-n_post) % max(n_dev, 1)
        post_seq = np.pad(index.post_seq.astype(np.int32), (0, pad),
                          constant_values=-1)
        post_pos = np.pad(index.post_pos.astype(np.int64), (0, pad),
                          constant_values=-1)
        spec = NamedSharding(
            mesh, P(*[axis if i == 0 else None for i in range(1)]))
        self.post_seq = jax.device_put(post_seq, spec)
        self.post_pos = jax.device_put(post_pos, spec)
        self.n_post = n_post
        self.shard_len = (n_post + pad) // max(n_dev, 1)
        self._fn = None

    def _lookup_fn(self, total: int):
        """shard_map'd gather: each device emits the postings it owns
        for the requested [start, count) ranges at their global output
        offsets; a psum merges the disjoint contributions."""
        from jax.experimental.shard_map import shard_map
        mesh, axis = self.mesh, self.axis
        shard_len = self.shard_len
        axis_names = mesh.axis_names

        def local(post_seq, post_pos, starts, counts, offs):
            # post_*: this device's shard [shard_len]
            ix = jax.lax.axis_index(axis)
            lo = ix * shard_len
            out_seq = jnp.zeros(total, jnp.int32)
            out_pos = jnp.zeros(total, jnp.int64)

            def word(k, carry):
                out_seq, out_pos = carry
                s, c, o = starts[k], counts[k], offs[k]
                # local overlap of [s, s+c)
                l0 = jnp.clip(s - lo, 0, shard_len)
                l1 = jnp.clip(s + c - lo, 0, shard_len)

                def body(i, carry):
                    out_seq, out_pos = carry
                    g = o + (lo + i - s)
                    out_seq = out_seq.at[g].add(post_seq[i])
                    out_pos = out_pos.at[g].add(post_pos[i])
                    return out_seq, out_pos

                return jax.lax.fori_loop(l0, l1, body,
                                         (out_seq, out_pos))

            out_seq, out_pos = jax.lax.fori_loop(
                0, starts.shape[0], word, (out_seq, out_pos))
            # disjoint ownership -> psum merges shards over ICI
            out_seq = jax.lax.psum(out_seq, axis)
            out_pos = jax.lax.psum(out_pos, axis)
            return out_seq, out_pos

        in_specs = (P(axis), P(axis), P(), P(), P())
        out_specs = (P(), P())
        fn = shard_map(local, mesh=mesh, in_specs=in_specs,
                       out_specs=out_specs, check_rep=False)
        return jax.jit(fn)

    def lookup_words(self, packed_words: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """All postings for the given packed words, concatenated in word
        order — bitwise equal to chaining Index.lookup_word on host.
        Returns (word_of_posting, seq_ids, positions)."""
        idx = self.index
        ix = np.searchsorted(idx.word_table, packed_words)
        ix = np.clip(ix, 0, max(len(idx.word_table) - 1, 0))
        hit = (len(idx.word_table) > 0) \
            & (idx.word_table[ix] == packed_words)
        starts = np.where(hit, idx.word_starts[ix], 0).astype(np.int64)
        counts = np.where(hit, idx.word_counts[ix], 0).astype(np.int64)
        offs = np.concatenate([[0], np.cumsum(counts)[:-1]]
                              ).astype(np.int64)
        total = int(counts.sum())
        if total == 0:
            return (np.zeros(0, np.int64), np.zeros(0, np.int32),
                    np.zeros(0, np.int64))
        fn = self._lookup_fn(total)
        with self.mesh:
            seqs, poss = fn(self.post_seq, self.post_pos,
                            jnp.asarray(starts), jnp.asarray(counts),
                            jnp.asarray(offs))
        word_of = np.repeat(np.arange(len(packed_words)), counts)
        return word_of, np.asarray(seqs), np.asarray(poss)
