"""End-to-end client/server mode: an in-process server (dataset +
word index built from FASTA) must yield the same alignments through
the line protocol as a local run (ref: exonerate-server.c protocol,
Analysis_Server_run analysis.c:1063-1101)."""
import io
import socket

import pytest

from exonerate_tpu.cli.exonerate import main
from exonerate_tpu.cli.server import ExonerateServer
from exonerate_tpu.db.dataset import dataset_build
from exonerate_tpu.db.index import Index, index_build

from benchmarks.fixtures import corpus_dir

DATA = corpus_dir()

CALM = DATA + "/cdna/calm.human.dna.fasta"


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("srv")
    esd = str(tmp / "db.esd.npz")
    esi = str(tmp / "db.esi.npz")
    dataset_build([CALM], esd)
    index_build(esd, esi)
    index = Index(esi)
    port = _free_port()
    srv = ExonerateServer(index.dataset, index, port)
    srv.start_background()
    yield f"localhost:{port}"
    srv.shutdown()


def run_cli(argv):
    out = io.StringIO()
    main(argv, out=out)
    return out.getvalue()


def _vulgar(text):
    return sorted(ln for ln in text.splitlines()
                  if ln.startswith("vulgar:"))


def test_server_matches_local(server):
    args = ["--bestn", "1", "--showvulgar", "yes",
            "--showalignment", "no", CALM]
    local = run_cli(args + [CALM])
    remote = run_cli(args + [server])
    assert _vulgar(local), local
    assert _vulgar(remote) == _vulgar(local)


def test_customserver_command(server):
    # --customserver sends a raw command before the session starts
    args = ["--bestn", "1", "--showvulgar", "yes", "--showalignment",
            "no", "--customserver", "version", CALM, server]
    text = run_cli(args)
    assert _vulgar(text)


def test_linecount_framing(server):
    """Multi-line replies carry the reference's linecount: header
    (ref: Socket_send, src/general/socket.c:160-172: value = reply
    lines + the header itself); single-line replies are bare.  The
    client reads framed replies without timeouts."""
    host, port = server.split(":")
    sock = socket.create_connection((host, int(port)), timeout=30)
    rfile = sock.makefile("rb")
    try:
        # single-line reply: no header
        sock.sendall(b"dbinfo\n")
        first = rfile.readline().decode()
        assert first.startswith("dbinfo:"), first
        # multi-line reply (help): linecount matches the line total
        sock.sendall(b"help\n")
        head = rfile.readline().decode()
        assert head.startswith("linecount:"), head
        n = int(head.split()[1])
        lines = [rfile.readline().decode() for _ in range(n - 1)]
        assert len(lines) == n - 1 and all(
            ln.endswith("\n") for ln in lines)
        # nothing left unread: the next command answers immediately
        sock.sendall(b"dbinfo\n")
        again = rfile.readline().decode()
        assert again.startswith("dbinfo:"), again
    finally:
        sock.close()


def test_client_reads_framed_replies(server):
    from exonerate_tpu.hub.client import AnalysisClient
    client = AnalysisClient(server)
    try:
        assert client.send("dbinfo").startswith("dbinfo:")
        lines = client.send_multi("help")
        assert len(lines) > 1
        # framing header is consumed, not surfaced
        assert not any(ln.startswith("linecount:") for ln in lines)
        # stream still in sync
        assert client.send("dbinfo").startswith("dbinfo:")
    finally:
        client.close()
