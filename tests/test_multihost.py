"""Multi-host sharding driver: chunked runs merged over the (simulated)
DCN all-gather must be byte-identical to the single-host run
(parallel/multihost.py; reference recipe: exonerate.1:177-204)."""
import io

import numpy as np

from exonerate_tpu.cli.exonerate import build_parser, make_analysis
from exonerate_tpu.parallel.multihost import (ChunkReport,
                                              gather_chunk_report,
                                              merge_chunk_reports)

rng = np.random.default_rng(21)


def _write_db(tmp_path):
    base = "".join(rng.choice(list("ACGT"), 2400))
    query = base[200:500]
    qf = tmp_path / "q.fa"
    qf.write_text(">q0\n" + query + "\n>q1\n" + base[900:1150] + "\n")
    targets = []
    for k in range(6):
        # each target carries a (mutated) copy of q0 so bestn ranks
        # across chunks, including exact ties from identical copies
        body = list(base[200:500])
        for pos in range(0, k * 20, 7):
            body[pos] = "ACGT"[(ord(body[pos]) + 1) % 4]
        targets.append(f">t{k}\n" + base[k*100:k*100+80]
                       + "".join(body) + base[1500:1700] + "\n")
    tf = tmp_path / "t.fa"
    tf.write_text("".join(targets))
    return str(qf), str(tf)


def _run(argv):
    v = build_parser().parse(argv)
    buf = io.StringIO()
    analysis = make_analysis(v, out=buf)
    analysis.process()
    return buf.getvalue()


def _run_chunk(argv, axis, cid, ctotal):
    v = build_parser().parse(
        argv + [f"--{axis}chunkid", str(cid),
                f"--{axis}chunktotal", str(ctotal)])
    buf = io.StringIO()
    analysis = make_analysis(v, out=buf)
    analysis.gam.defer_report = True
    analysis.process()
    rep = gather_chunk_report(analysis, buf)
    rep.chunk_id = cid
    return rep, analysis.gam.gas.best_n


def _merged(argv, axis, n_chunks):
    reports = []
    best_n = 0
    for c in range(1, n_chunks + 1):
        rep, best_n = _run_chunk(argv, axis, c, n_chunks)
        reports.append(rep)
    # merge must not depend on arrival order
    return merge_chunk_reports(reports[::-1], best_n)


def test_target_chunk_bestn_merge(tmp_path):
    qf, tf = _write_db(tmp_path)
    argv = ["-m", "affine:local", "--showvulgar", "yes",
            "--showalignment", "no", "--bestn", "2", "--score", "120",
            qf, tf]
    single = _run(argv)
    assert single.count("vulgar:") >= 2
    assert _merged(argv, "target", 3) == single


def test_query_chunk_merge(tmp_path):
    qf, tf = _write_db(tmp_path)
    argv = ["-m", "affine:local", "--showvulgar", "yes",
            "--showalignment", "no", "--bestn", "1", "--score", "120",
            qf, tf]
    single = _run(argv)
    assert _merged(argv, "query", 2) == single


def test_target_chunk_no_bestn_merge(tmp_path):
    qf, tf = _write_db(tmp_path)
    argv = ["-m", "affine:local", "--showcigar", "yes",
            "--showalignment", "no", "--score", "120", qf, tf]
    single = _run(argv)
    assert _merged(argv, "target", 3) == single


def test_merge_tie_rank_semantics():
    """Tie groups admit beyond N and evict wholesale (ref: gam.c:267-326);
    the merge must reproduce that across chunk boundaries."""
    r1 = ChunkReport(1, "", {"q": [(100, "a#%_EXONERATE_BESTN_RANK_%\n", 0),
                                   (90, "b#%_EXONERATE_BESTN_RANK_%\n", 1)]})
    r2 = ChunkReport(2, "", {"q": [(100, "c#%_EXONERATE_BESTN_RANK_%\n", 0),
                                   (80, "d#%_EXONERATE_BESTN_RANK_%\n", 1)]})
    out = merge_chunk_reports([r2, r1], best_n=1)
    # both 100-scoring ties survive bestn 1 (fewer than 1 strictly
    # better); 90/80 evicted; chunk-major order within the tie
    assert out == "a#1\nc#2\n"


def test_sharded_single_pair_est2genome_matches_single_device():
    """One est2genome pair's DP sharded sp=2: the per-diagonal state
    vectors split over the mesh, rolls become collective permutes, and
    the score/region result is exactly the single-device wavefront's
    (VERDICT r1 next #5)."""
    import numpy as np
    import jax
    from jax.sharding import Mesh
    from exonerate_tpu.alphabet import Alphabet, AlphabetType
    from exonerate_tpu.seqio import Sequence
    from exonerate_tpu.model.est2genome import est2genome_create
    from exonerate_tpu.model.data import AlignData, IntronArgs
    from exonerate_tpu.engine.region import Region
    from exonerate_tpu.engine import wavefront
    from exonerate_tpu.parallel.sharded_pair import \
        find_region_sharded_pair

    rng = np.random.default_rng(3)
    dna = Alphabet(AlphabetType.DNA)
    ex1 = "".join(rng.choice(list("ACGT"), 120))
    ex2 = "".join(rng.choice(list("ACGT"), 120))
    intr = "GT" + "".join(rng.choice(list("ACGT"), 76)) + "AG"
    genome = ("".join(rng.choice(list("ACGT"), 50)) + ex1 + intr + ex2
              + "".join(rng.choice(list("ACGT"), 50)))
    q = Sequence("q", None, ex1 + ex2, dna)
    t = Sequence("t", None, genome, dna)
    ia = IntronArgs(min_intron=20, max_intron=1000)
    model = est2genome_create(ia)
    data = AlignData(q, t)
    data.intron = ia
    region = Region(0, 0, len(q), len(t))

    single = wavefront.find_region(model, region, data)

    devs = np.array(jax.devices()[:2])
    mesh = Mesh(devs.reshape(1, 2), ("dp", "sp"))
    sharded = find_region_sharded_pair(model, region, data, mesh)
    assert sharded.score == single.score
    assert (sharded.query_start, sharded.target_start,
            sharded.query_end, sharded.target_end) == (
        single.query_start, single.target_start,
        single.query_end, single.target_end)


def test_target_tiled_single_pair_matches_single_device():
    """One pair's TARGET axis tiled over 'sp' (chromosome-scale memory
    partition, SURVEY.md §2.13): exact full-result parity with the
    single-device wavefront."""
    import jax
    import numpy as np
    from jax.sharding import Mesh
    from exonerate_tpu.alphabet import Alphabet, AlphabetType
    from exonerate_tpu.seqio import Sequence
    from exonerate_tpu.model.est2genome import est2genome_create
    from exonerate_tpu.model.data import AlignData, IntronArgs
    from exonerate_tpu.engine.region import Region
    from exonerate_tpu.engine import wavefront
    from exonerate_tpu.parallel.sharded_pair import \
        find_region_target_tiled

    rng = np.random.default_rng(9)
    dna = Alphabet(AlphabetType.DNA)
    ex1 = "".join(rng.choice(list("ACGT"), 100))
    ex2 = "".join(rng.choice(list("ACGT"), 100))
    intr = "GT" + "".join(rng.choice(list("ACGT"), 60)) + "AG"
    genome = ("".join(rng.choice(list("ACGT"), 40)) + ex1 + intr + ex2
              + "".join(rng.choice(list("ACGT"), 40)))
    q = Sequence("q", None, ex1 + ex2, dna)
    t = Sequence("t", None, genome, dna)
    ia = IntronArgs(min_intron=20, max_intron=1000)
    model = est2genome_create(ia)
    data = AlignData(q, t)
    data.intron = ia
    region = Region(0, 0, len(q), len(t))

    single = wavefront.find_region(model, region, data)
    devs = np.array(jax.devices()[:4])
    mesh = Mesh(devs.reshape(1, 4), ("dp", "sp"))
    tiled = find_region_target_tiled(model, region, data, mesh)
    assert (tiled.score, tiled.query_start, tiled.target_start,
            tiled.query_end, tiled.target_end) == (
        single.score, single.query_start, single.target_start,
        single.query_end, single.target_end), (tiled, single)


def test_multiprocess_query_job_matches_single_process(tmp_path):
    """Two CLI processes joined by --coordinator/--processcount/
    --processid (jax.distributed on the CPU) print, from process 0,
    exactly the single-process report."""
    import os
    import socket
    import subprocess
    import sys
    qf, tf = _write_db(tmp_path)
    args = ["--bestn", "2", "--showvulgar", "yes", "--showalignment",
            "no", qf, tf]
    want = _run(args)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=repo,
               XLA_FLAGS="")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "exonerate_tpu.cli.exonerate"] + args
        + ["--multihost", "query", "--coordinator", f"localhost:{port}",
           "--processcount", "2", "--processid", str(k)],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=env) for k in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    got = "".join(ln for ln in outs[0].splitlines(True)
                  if not ln.startswith(("Command line:", "Hostname:",
                                        "-- completed", "[Gloo]")))
    assert got == want
    assert outs[1].count("vulgar:") == 0
