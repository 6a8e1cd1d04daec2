"""EXTMEM lazy sequences (ref: sequence.h:111-114, fastadb.h:111)."""
import numpy as np

from exonerate_tpu.extmem import (index_fasta, lazy_sequence,
                                  MmapFastaLoader, PageCache)
from exonerate_tpu.seqio import FastaDB, iter_fasta

from benchmarks.fixtures import corpus_dir

DATA = corpus_dir()

CALM = DATA + "/cdna/calm.human.dna.fasta"


def test_lazy_windows_match_eager():
    recs = index_fasta(CALM)
    loader = MmapFastaLoader(CALM)
    lazy = lazy_sequence(recs[0], loader)
    eager = list(iter_fasta(CALM))[0]
    assert lazy.is_lazy and len(lazy) == len(eager)
    assert np.array_equal(lazy.subseq(1000, 500).data,
                          eager.data[1000:1500])
    assert lazy.is_lazy  # windows must not materialize
    rc = lazy.revcomp_lazy()
    assert np.array_equal(rc.subseq(0, 100).data,
                          eager.revcomp().data[:100])
    assert np.array_equal(lazy.data, eager.data)


def test_fastadb_extmem_iteration():
    db = FastaDB(CALM, suffix=".fasta", extmem=True)
    seqs = list(db)
    eager = list(iter_fasta(CALM))
    assert [s.id for s in seqs] == [s.id for s in eager]
    assert seqs[0].is_lazy
    assert seqs[0].gcg_checksum() == eager[0].gcg_checksum()


def test_page_cache_eviction():
    calls = []

    def loader(start, n):
        calls.append((start, n))
        return (np.arange(start, start + n) % 251).astype(np.uint8)

    pc = PageCache(1 << 20, loader, max_pages=2)
    a = pc.read(0, 100)
    b = pc.read(0, 100)           # cached: no new load
    assert np.array_equal(a, b) and len(calls) == 1
    pc.read(3 << 16, 10)          # page 3
    pc.read(5 << 16, 10)          # page 5 -> evicts page 0
    pc.read(0, 10)                # reload page 0
    assert len(calls) == 4
