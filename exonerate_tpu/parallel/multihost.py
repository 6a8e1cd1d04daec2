"""Multi-process sharding driver.

The reference scales across a cluster by chunking databases with
--querychunkid/--querychunktotal/--targetchunkid/--targetchunktotal and
concatenating per-job outputs externally (ref: doc/man/man1/exonerate.1
:177-204, src/database/fastadb.h:72-73, src/program/exonerate.c:62-73).
This driver makes that recipe first-class for a JAX multi-process job:
every process launches the same command with --multihost query|target
(and --coordinator/--processcount/--processid, which join the job:
nothing detects a cluster on its own), the driver assigns each process
its chunk on that axis, runs the analysis locally (device band scans,
native engines — identical to a single-process chunk run), and merges
results with one uint8 all-gather across processes:

- per-query bestn stores merge with GAM's exact admit/evict/tie rules,
  submission order extended chunk-major (chunks partition the stream in
  order, so (chunk, local order) IS the single-host submission order);
- non-bestn output concatenates chunk-major (the reference's external
  concat, done for the user).

Process 0 prints the merged report; the others print nothing.  With
--multihost query and bestn, or any --multihost target run, the output
is byte-identical to the same single-process command.
"""
from __future__ import annotations

import pickle
from dataclasses import dataclass

# a chunk's local submission orders stay below this; global order =
# chunk_id * _ORDER_STRIDE + local_order keeps chunk-major tie-breaking
_ORDER_STRIDE = 1 << 40


@dataclass
class ChunkReport:
    chunk_id: int                     # 1-based, as the chunk flags use
    stream_text: str                  # non-bestn output, stream order
    bestn: dict                       # qid -> list[(score, text, order)]


def gather_chunk_report(analysis, buf) -> ChunkReport:
    """Extract one host's results after analysis.process() ran with
    gam.defer_report set (bestn replay suppressed)."""
    bestn = {qid: [(s.score, s.text, s.order) for s in store]
             for qid, store in analysis.gam.bestn_store.items()}
    return ChunkReport(chunk_id=0, stream_text=buf.getvalue(),
                       bestn=bestn)


def merge_chunk_reports(reports: list[ChunkReport], best_n: int) -> str:
    """Merge chunk outputs into the single-host report text.

    bestn merge replays GAM.report()'s exact semantics (ref: GAM_report,
    gam.c:550-556; admit/evict ref: gam.c:267-326): per query in
    id-sorted order, entries sorted (score desc, submission order asc),
    kept while fewer than best_n strictly better exist, ranks 1..N
    spliced over the %_EXONERATE_BESTN_RANK_% placeholder."""
    reports = sorted(reports, key=lambda r: r.chunk_id)
    parts = [r.stream_text for r in reports]
    if best_n:
        store: dict = {}
        for r in reports:
            for qid, entries in r.bestn.items():
                dst = store.setdefault(qid, [])
                for score, text, order in entries:
                    dst.append((score,
                                r.chunk_id * _ORDER_STRIDE + order,
                                text))
        for qid in sorted(store):
            entries = sorted(store[qid], key=lambda e: (-e[0], e[1]))
            scores = [e[0] for e in entries]
            kept = [e for e in entries
                    if sum(1 for sc in scores if sc > e[0]) < best_n]
            for rank, (_s, _o, text) in enumerate(kept, 1):
                parts.append(text.replace("%_EXONERATE_BESTN_RANK_%",
                                          str(rank)))
    return "".join(parts)


def _allgather_bytes(data: bytes) -> list[bytes]:
    """All-gather one byte blob per process (identity when
    single-process)."""
    import jax
    if jax.process_count() == 1:
        return [data]
    import numpy as np
    from jax.experimental import multihost_utils
    P = jax.process_count()
    lens = multihost_utils.process_allgather(
        np.asarray([len(data)], np.int64)).reshape(P)
    m = int(lens.max())
    buf = np.zeros(max(m, 1), np.uint8)
    buf[:len(data)] = np.frombuffer(data, np.uint8)
    gathered = np.asarray(
        multihost_utils.process_allgather(buf)).reshape(P, -1)
    return [gathered[i, :int(lens[i])].tobytes() for i in range(P)]


def run_multihost(v: dict, axis: str, out) -> None:
    """Drive one process's share of a multi-process run and print the
    merged report on process 0.  ``v`` is the parsed CLI value dict."""
    import io

    import jax

    from ..cli.exonerate import make_analysis

    assert axis in ("query", "target"), axis
    if v["coordinator"] != "NULL":
        jax.distributed.initialize(coordinator_address=v["coordinator"],
                                   num_processes=v["processcount"],
                                   process_id=v["processid"])
    P = jax.process_count()
    p = jax.process_index()
    if v[f"{axis}chunktotal"]:
        raise SystemExit(
            f"--multihost {axis} assigns --{axis}chunkid/total itself; "
            "drop the explicit chunk flags")
    v = dict(v)
    v[f"{axis}chunkid"] = p + 1
    v[f"{axis}chunktotal"] = P
    buf = io.StringIO()
    analysis = make_analysis(v, out=buf)
    analysis.gam.defer_report = True
    analysis.process()
    report = gather_chunk_report(analysis, buf)
    report.chunk_id = p + 1
    blobs = _allgather_bytes(pickle.dumps(report))
    if p == 0:
        reports = [pickle.loads(b) for b in blobs]
        out.write(merge_chunk_reports(reports, analysis.gam.gas.best_n))
