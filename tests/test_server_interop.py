"""Cross-implementation client/server interop.

The wire protocol (ref: exonerate-server.c:209-248) is byte-compatible
in both directions: the unmodified C exonerate client aligns through
OUR server, and our client aligns through the shim-built C
exonerate-server.  Both must produce the same vulgar lines as a local
run.
"""
import io
import os
import socket
import subprocess
import time

import pytest

from benchmarks.fixtures import corpus_dir

DATA = corpus_dir()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_BIN = os.path.join(REPO, "build", "ref", "bin")
CALM = DATA + "/cdna/calm.human.dna.fasta"

pytestmark = pytest.mark.skipif(
    not os.path.exists(os.path.join(REF_BIN, "exonerate-server")),
    reason="shim-built reference binaries not present "
           "(tools/refbuild/build.sh)")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _wait_port(port, timeout=20):
    t0 = time.time()
    while time.time() - t0 < timeout:
        try:
            socket.create_connection(("127.0.0.1", port),
                                     timeout=1).close()
            return
        except OSError:
            time.sleep(0.2)
    raise TimeoutError(f"port {port} never opened")


def _vulgar(text):
    return sorted(ln for ln in text.splitlines()
                  if ln.startswith("vulgar:"))


ARGS = ["--bestn", "1", "--showvulgar", "yes", "--showalignment", "no"]


def _our_cli(argv):
    from exonerate_tpu.cli.exonerate import main
    out = io.StringIO()
    rc = main(argv, out=out)
    assert not rc
    return out.getvalue()


def test_our_client_vs_c_server(tmp_path):
    esd = str(tmp_path / "calm.esd")
    esi = str(tmp_path / "calm.esi")
    subprocess.run([os.path.join(REF_BIN, "fasta2esd"), CALM, esd],
                   check=True, capture_output=True, timeout=300)
    subprocess.run([os.path.join(REF_BIN, "esd2esi"), esd, esi],
                   check=True, capture_output=True, timeout=300)
    port = _free_port()
    proc = subprocess.Popen(
        [os.path.join(REF_BIN, "exonerate-server"), esi,
         "--port", str(port)],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        _wait_port(port)
        remote = _our_cli(ARGS + [CALM, f"localhost:{port}"])
    finally:
        proc.kill()
        proc.wait()
    local = _our_cli(ARGS + [CALM, CALM])
    assert _vulgar(remote) == _vulgar(local)
    assert any("10875" in ln for ln in _vulgar(remote))


def test_c_client_vs_our_server(tmp_path):
    from exonerate_tpu.cli.server import ExonerateServer
    from exonerate_tpu.db.dataset import dataset_build
    from exonerate_tpu.db.index import Index, index_build
    esd = str(tmp_path / "db.esd.npz")
    esi = str(tmp_path / "db.esi.npz")
    dataset_build([CALM], esd)
    index_build(esd, esi)
    index = Index(esi)
    port = _free_port()
    srv = ExonerateServer(index.dataset, index, port)
    srv.start_background()
    try:
        _wait_port(port)
        r = subprocess.run(
            [os.path.join(REF_BIN, "exonerate")] + ARGS
            + [CALM, f"localhost:{port}"],
            capture_output=True, text=True, timeout=300)
    finally:
        srv.shutdown()
    assert r.returncode == 0, r.stderr[-500:]
    assert any("10875" in ln for ln in _vulgar(r.stdout))


def _raw_session(port, commands):
    """Drive a server over the raw line protocol.  Multi-line replies
    (get hsps) have no terminator; drain with select (the shim-built C
    server mishandles batched request lines, so send one at a time)."""
    import select
    s = socket.create_connection(("127.0.0.1", port), timeout=60)
    f = s.makefile("rwb")
    replies = []
    for cmd in commands:
        f.write((cmd + "\n").encode())
        f.flush()
        reply = []
        deadline = time.time() + 30
        while time.time() < deadline:
            if select.select([s], [], [], 0.5)[0]:
                ln = f.readline().decode()
                if not ln:
                    break
                reply.append(ln)
                deadline = time.time() + 1.0
            elif reply:
                break
        replies.append("".join(reply))
    f.write(b"exit\n")
    f.flush()
    s.close()
    return replies


PROT = DATA + "/protein/calm.human.protein.fasta"


def test_translated_index_protein_query_matches_c_server(tmp_path):
    """Protein query vs DNA genome through the translated index: our
    server must return the same hspset: lines as the C server
    (ref: index.c translated path, index.h:55-147)."""
    from exonerate_tpu.seqio import iter_fasta
    from exonerate_tpu.cli.server import ExonerateServer
    from exonerate_tpu.db.dataset import dataset_build
    from exonerate_tpu.db.index import Index, index_build
    pep = str(list(iter_fasta(PROT))[0])

    # C side
    esd = str(tmp_path / "c.esd")
    esi = str(tmp_path / "c.esi")
    subprocess.run([os.path.join(REF_BIN, "fasta2esd"),
                    "--softmask", "no", CALM, esd],
                   check=True, capture_output=True, timeout=300)
    subprocess.run([os.path.join(REF_BIN, "esd2esi"),
                    "--translate", "yes", esd, esi],
                   check=True, capture_output=True, timeout=300)
    cport = _free_port()
    proc = subprocess.Popen(
        [os.path.join(REF_BIN, "exonerate-server"), esi,
         "--port", str(cport)],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)

    # our side
    oesd = str(tmp_path / "o.esd.npz")
    oesi = str(tmp_path / "o.esi.npz")
    dataset_build([CALM], oesd)
    index_build(oesd, oesi, wordlen=6, translated=True)
    index = Index(oesi)
    oport = _free_port()
    srv = ExonerateServer(index.dataset, index, oport)
    srv.start_background()

    cmds = ["set query " + pep, "get hsps",
            "revcomp target", "get hsps"]
    try:
        _wait_port(cport)
        _wait_port(oport)
        c_replies = _raw_session(cport, cmds)
        o_replies = _raw_session(oport, cmds)
    finally:
        proc.kill()
        proc.wait()
        srv.shutdown()

    def hspsets(replies):
        return sorted(ln for r in replies for ln in r.splitlines()
                      if ln.startswith("hspset:"))

    c_hsps = hspsets(c_replies)
    o_hsps = hspsets(o_replies)
    assert c_hsps, f"C server returned no hspsets: {c_replies}"
    assert o_hsps == c_hsps


def test_geneseed_two_tier_matches_c_server(tmp_path):
    """Two-tier geneseed seeding server-side (ref:
    Index_get_HSPsets_geneseed, index.h:140-147): identical hspset:
    lines from both servers for a mutated query with geneseed params."""
    import numpy as np
    from exonerate_tpu.seqio import iter_fasta
    from exonerate_tpu.cli.server import ExonerateServer
    from exonerate_tpu.db.dataset import dataset_build
    from exonerate_tpu.db.index import Index, index_build
    calm = str(list(iter_fasta(CALM))[0])
    rng = np.random.default_rng(5)
    q = list(calm[100:900])
    for _ in range(60):
        q[rng.integers(0, len(q))] = "ACGT"[rng.integers(0, 4)]
    q = "".join(q)

    esd = str(tmp_path / "c.esd")
    esi = str(tmp_path / "c.esi")
    subprocess.run([os.path.join(REF_BIN, "fasta2esd"),
                    "--softmask", "no", CALM, esd],
                   check=True, capture_output=True, timeout=300)
    subprocess.run([os.path.join(REF_BIN, "esd2esi"), esd, esi],
                   check=True, capture_output=True, timeout=300)
    cport = _free_port()
    proc = subprocess.Popen(
        [os.path.join(REF_BIN, "exonerate-server"), esi,
         "--port", str(cport)],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)

    oesd = str(tmp_path / "o.esd.npz")
    oesi = str(tmp_path / "o.esi.npz")
    dataset_build([CALM], oesd)
    index_build(oesd, oesi, wordlen=12)
    index = Index(oesi)
    oport = _free_port()
    srv = ExonerateServer(index.dataset, index, oport)
    srv.start_background()

    cmds = ["set param geneseedthreshold 120",
            "set param geneseedrepeat 1",
            "set param maxqueryspan 200",
            "set param maxtargetspan 200",
            "set query " + q,
            "get hsps"]
    try:
        _wait_port(cport)
        _wait_port(oport)
        c_replies = _raw_session(cport, cmds)
        o_replies = _raw_session(oport, cmds)
    finally:
        proc.kill()
        proc.wait()
        srv.shutdown()

    def hspset_lines(replies):
        """Raw hspset: lines, order preserved — byte parity is the
        contract.  Our geneseed keepers run through a faithful
        RangeTree whose recent set calls the REAL glibc tsearch/
        tdelete (db/rangetree.py), so the intra-set order reproduces
        the C server's root-eviction + kd-tree in-order emission
        (rangetree.c:102-130)."""
        out = []
        for r in replies:
            for ln in r.splitlines():
                if ln.startswith("hspset:") and "empty" not in ln:
                    out.append(ln)
        return out

    c_hsps = hspset_lines(c_replies)
    o_hsps = hspset_lines(o_replies)
    assert c_hsps, c_replies
    assert o_hsps == c_hsps


def test_softmask_and_desaturation_match_c_server(tmp_path):
    """Index-build parity for genome-scale serving (round-4 fixes):
    (a) softmasked (lowercase) target words are never posted — the
    reference indexes the MASKED sequence view (Sequence_mask,
    index.c:309); (b) words occurring >= expect+saturatethreshold
    times per strand are removed entirely (Index_desaturate,
    index.c:352-381; esd2esi default threshold 10).  Raw hspset: line
    equality for forward and revcomp queries over a target exercising
    both: repeated gene copies inside softmasked background."""
    import numpy as np
    from exonerate_tpu.cli.server import ExonerateServer
    from exonerate_tpu.db.dataset import dataset_build
    from exonerate_tpu.db.index import Index, index_build

    rng = np.random.default_rng(23)
    gene = "".join(rng.choice(list("ACGT"), 400).tolist())
    # a 24-mer repeated twice per gene copy: 2*6 = 12 occurrences >=
    # the desaturation expect (~10), while single-copy gene words (6
    # occurrences) survive — so the motif words (and only they) must
    # be removed from the index
    motif = "".join(rng.choice(list("ACGT"), 24).tolist())
    gene = gene[:100] + motif + gene[124:300] + motif + gene[324:]
    chunks = []
    for _ in range(6):
        chunks.append("".join(rng.choice(list("acgt"), 500).tolist()))
        chunks.append(gene)
    target = "".join(chunks)
    tfa = str(tmp_path / "t.fa")
    with open(tfa, "w") as f:
        f.write(">tseq\n")
        for i in range(0, len(target), 60):
            f.write(target[i:i + 60] + "\n")
    q = list(gene)
    for _ in range(8):
        q[int(rng.integers(0, len(q)))] = "ACGT"[int(rng.integers(0, 4))]
    q = "".join(q)

    esd = str(tmp_path / "c.esd")
    esi = str(tmp_path / "c.esi")
    subprocess.run([os.path.join(REF_BIN, "fasta2esd"), tfa, esd],
                   check=True, capture_output=True, timeout=300)
    subprocess.run([os.path.join(REF_BIN, "esd2esi"), esd, esi],
                   check=True, capture_output=True, timeout=300)
    cport = _free_port()
    proc = subprocess.Popen(
        [os.path.join(REF_BIN, "exonerate-server"), esi,
         "--port", str(cport)],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)

    oesd = str(tmp_path / "o.esd.npz")
    oesi = str(tmp_path / "o.esi.npz")
    dataset_build([tfa], oesd)
    index_build(oesd, oesi)
    index = Index(oesi)
    oport = _free_port()
    srv = ExonerateServer(index.dataset, index, oport)
    srv.start_background()

    cmds = ["set query " + q, "get hsps", "revcomp query", "get hsps"]
    try:
        _wait_port(cport)
        _wait_port(oport)
        c_replies = _raw_session(cport, cmds)
        o_replies = _raw_session(oport, cmds)
    finally:
        proc.kill()
        proc.wait()
        srv.shutdown()

    c_hsps = [ln for r in c_replies for ln in r.splitlines()
              if ln.startswith("hspset:")]
    o_hsps = [ln for r in o_replies for ln in r.splitlines()
              if ln.startswith("hspset:")]
    assert any("empty" not in ln for ln in c_hsps), c_replies
    assert o_hsps == c_hsps


def test_customserver_both_directions(tmp_path):
    """--customserver sends one raw pre-command line expecting an ok:
    reply (ref: analysis.c:55-58, 487-491): our client against the C
    server and the C client against our server, both with the flag —
    results must equal the flagless runs."""
    from exonerate_tpu.cli.server import ExonerateServer
    from exonerate_tpu.db.dataset import dataset_build
    from exonerate_tpu.db.index import Index, index_build

    esd = str(tmp_path / "c.esd")
    esi = str(tmp_path / "c.esi")
    subprocess.run([os.path.join(REF_BIN, "fasta2esd"), CALM, esd],
                   check=True, capture_output=True, timeout=300)
    subprocess.run([os.path.join(REF_BIN, "esd2esi"), esd, esi],
                   check=True, capture_output=True, timeout=300)
    cport = _free_port()
    proc = subprocess.Popen(
        [os.path.join(REF_BIN, "exonerate-server"), esi,
         "--port", str(cport)],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    custom = ["--customserver", "set param seedrepeat 1"]
    try:
        _wait_port(cport)
        ours_plain = _our_cli(ARGS + [CALM, f"localhost:{cport}"])
        ours_custom = _our_cli(ARGS + custom
                               + [CALM, f"localhost:{cport}"])
    finally:
        proc.kill()
        proc.wait()
    assert _vulgar(ours_custom) == _vulgar(ours_plain)
    assert any("10875" in ln for ln in _vulgar(ours_custom))

    oesd = str(tmp_path / "o.esd.npz")
    oesi = str(tmp_path / "o.esi.npz")
    dataset_build([CALM], oesd)
    index_build(oesd, oesi)
    index = Index(oesi)
    oport = _free_port()
    srv = ExonerateServer(index.dataset, index, oport)
    srv.start_background()
    try:
        _wait_port(oport)
        r = subprocess.run(
            [os.path.join(REF_BIN, "exonerate")] + ARGS + custom
            + [CALM, f"localhost:{oport}"],
            capture_output=True, text=True, timeout=300)
    finally:
        srv.shutdown()
    assert r.returncode == 0, r.stderr[-300:]
    assert any("10875" in ln for ln in _vulgar(r.stdout))
