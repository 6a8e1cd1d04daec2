"""Row-scan engine timing harness on the attached device.

Builds a synthetic band-compressed pair at a given (model, Q, W) shape
(the inputs the production hybrid would ship), compiles the fused
reverse+forward row pass, and times warm batched calls with value
fetches.

Usage: python tools/rowbench.py [MODEL] [Q] [T] [B] [n_loci]
  MODEL  EST2GENOME | PROTEIN2GENOME | ... (default EST2GENOME)
  Q      query length (default 1216)
  T      target length (default 1_000_000)
  B      batch size (default 8)
  n_loci seed clusters (default 12)
"""
from __future__ import annotations

import os
import sys
import time
from types import SimpleNamespace

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def build_job(mtname, Q, T, n_loci, seed=7, margin=1024):
    from exonerate_tpu.alphabet import AlphabetType
    from exonerate_tpu.model.registry import ModelType, get_model
    from exonerate_tpu.model.data import AlignData
    from exonerate_tpu.seqio import Sequence
    from exonerate_tpu.engine.sdp import SDPPair, SdpArgs
    from exonerate_tpu.engine import sdp_bands
    rng = np.random.default_rng(seed)
    A = AlphabetType
    qt = (A.PROTEIN, A.DNA) if mtname.startswith("PROTEIN") \
        else (A.DNA, A.DNA)
    tadv = 3 if mtname in ("PROTEIN2GENOME", "PROTEIN2DNA",
                           "CODING2GENOME", "CODING2CODING") else 1
    if qt[0] == A.PROTEIN:
        q = "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), Q))
    else:
        q = "".join(rng.choice(list("ACGT"), Q))
    t = "".join(rng.choice(list("ACGT"), T))
    model = get_model(ModelType[mtname], *qt)
    qs = Sequence("q", None, q)
    ts = Sequence("t", None, t)
    data = AlignData(qs, ts)
    hl = []
    for k in range(n_loci):
        ts0 = int((k + 0.5) * T / n_loci)
        qs0 = int(rng.integers(0, max(1, Q - 40)))
        hl.append(SimpleNamespace(query_start=qs0, target_start=ts0,
                                  length=20, score=200, cobs=10))
    hs = SimpleNamespace(qadv=1, tadv=tadv, hsps=hl)
    comp = SimpleNamespace(query=qs, target=ts, hspsets=lambda: [hs])
    os.environ["EXONERATE_TPU_SDP"] = "python"
    pair = SDPPair(model, comp, data, None, SdpArgs())
    os.environ.pop("EXONERATE_TPU_SDP", None)
    extents = [(s.hsp.target_start,
                s.hsp.target_start + s.hsp.length * tadv)
               for s in pair.seeds]
    sw = max((sp.max_target for sp in model.spans), default=0)
    plan = sdp_bands.plan_bands(extents, Q, T, margin=margin,
                                span_window=sw + 2 * margin)
    return model, pair, plan


def main(mtname="EST2GENOME", Q=1216, T=1_000_000, B=8, n_loci=12):
    import jax
    from exonerate_tpu.engine import sdp_device, sdp_rows
    print(f"backend={jax.default_backend()} devices={len(jax.devices())}")
    model, pair, plan = build_job(mtname, Q, T, n_loci)
    print(f"{mtname}: Q={Q} W={plan.W} loci={len(plan.loci)} "
          f"seeds={len(pair.seeds)}")
    Qp = Q
    Wp = 1 << max(10, (plan.W - 1).bit_length())
    n_seed_pad = max(8, 1 << (len(pair.seeds) - 1).bit_length())
    n_seg_pad = max(8, 1 << len(plan.loci).bit_length())
    inputs, kinds = sdp_device.prepare_inputs(model, pair, plan,
                                              pad_to=(Qp, Wp))
    inputs.update(sdp_device.prepare_seeds(pair, plan, n_seed_pad))
    exts = sdp_rows.chain_ext_values(model, pair)
    fn = sdp_rows.get_fn(model, Qp, Wp, kinds, pair.use_boundary,
                         n_seed_pad, n_seg_pad, pair.args.dropoff,
                         exts, batched=B > 1)
    import jax.tree_util as jtu
    if B > 1:
        inputs = jtu.tree_map(lambda a: np.broadcast_to(
            np.asarray(a), (B,) + np.shape(a)), inputs)
    t0 = time.perf_counter()
    args_dev = jax.device_put(inputs)
    out = jtu.tree_map(np.asarray, fn(args_dev))
    compile_s = time.perf_counter() - t0
    best = None
    for _ in range(4):
        t0 = time.perf_counter()
        out = jtu.tree_map(np.asarray, fn(args_dev))
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    cells = B * (Qp + 1) * (plan.W + 1) * 2   # reverse + forward
    band = out["band_end"]
    sweeps = out["sweeps"]
    print(f"compile+first {compile_s:.1f}s; warm best {best*1e3:.1f} "
          f"ms/batch = {best/B*1e3:.2f} ms/DP "
          f"({cells/best/1e9:.2f} GCUPS both passes), "
          f"max sweeps {np.max(sweeps)}")
    print("band_end sample", np.asarray(band).reshape(B, -1)[0][:6])
    return best / B


if __name__ == "__main__":
    a = sys.argv[1:]
    main(a[0] if a else "EST2GENOME",
         int(a[1]) if len(a) > 1 else 1216,
         int(a[2]) if len(a) > 2 else 1_000_000,
         int(a[3]) if len(a) > 3 else 8,
         int(a[4]) if len(a) > 4 else 12)
