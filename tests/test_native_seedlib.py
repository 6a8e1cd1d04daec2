"""Cross-check the native C++ seeding machine against the Python HspSet."""
import numpy as np
import pytest

from exonerate_tpu import native
from exonerate_tpu.alphabet import Alphabet, AlphabetType
from exonerate_tpu.model.match import Match, MatchArgs, MatchType
from exonerate_tpu.seeds.hsp import HspArgs, HspParam, HspSet
from exonerate_tpu.seqio import Sequence, iter_fasta

from benchmarks.fixtures import corpus_dir

DATA = corpus_dir()

rng = np.random.default_rng(7)


def make_pair(n=400, m=600):
    alpha = Alphabet(AlphabetType.DNA)
    base = "".join(rng.choice(list("ACGT"), m))
    # query: two fragments of the target plus noise
    q = (base[50:150] + "".join(rng.choice(list("ACGT"), 80))
         + base[300:420])
    return (Sequence("q", None, q, alpha),
            Sequence("t", None, base, alpha))


def collect_seeds(query, target, wordlen=12):
    qs = str(query)
    seeds = []
    words = {}
    for i in range(len(qs) - wordlen + 1):
        words.setdefault(qs[i:i + wordlen], []).append(i)
    ts = str(target)
    for j in range(len(ts) - wordlen + 1):
        for qpos in reversed(words.get(ts[j:j + wordlen], ())):
            seeds.append((qpos, j))
    seeds.sort(key=lambda s: s[1])
    return seeds


def test_native_matches_python():
    if native.get_lib() is None:
        pytest.skip("native toolchain unavailable")
    q, t = make_pair()
    param = HspParam(Match(MatchType.DNA2DNA, MatchArgs()), HspArgs())
    seeds = collect_seeds(q, t)
    assert seeds
    py = HspSet(q, t, param)
    for s in seeds:
        py.seed(*s)
    py.finalise()
    nat = HspSet(q, t, param)
    nat.seed_batch(seeds)
    got = [(h.query_start, h.target_start, h.length, h.score, h.cobs)
           for h in nat.hsps]
    want = [(h.query_start, h.target_start, h.length, h.score, h.cobs)
            for h in py.hsps]
    assert got == want
    assert want  # found the planted fragments


def test_native_seed_repeat():
    if native.get_lib() is None:
        pytest.skip("native toolchain unavailable")
    q, t = make_pair()
    args = HspArgs(seed_repeat=2)
    param = HspParam(Match(MatchType.DNA2DNA, MatchArgs()), args)
    seeds = collect_seeds(q, t)
    py = HspSet(q, t, param)
    for s in seeds:
        py.seed(*s)
    py.finalise()
    nat = HspSet(q, t, param)
    nat.seed_batch(seeds)
    assert ([(h.query_start, h.target_start, h.length, h.score)
             for h in nat.hsps]
            == [(h.query_start, h.target_start, h.length, h.score)
                for h in py.hsps])


def test_calm_selfalign_native():
    if native.get_lib() is None:
        pytest.skip("native toolchain unavailable")
    calm = list(iter_fasta(
        DATA + "/cdna/calm.human.dna.fasta"))[0]
    calm.strand = "+"
    param = HspParam(Match(MatchType.DNA2DNA, MatchArgs()), HspArgs())
    seeds = collect_seeds(calm, calm)
    hs = HspSet(calm, calm, param)
    hs.seed_batch(seeds)
    assert max(h.score for h in hs.hsps) == 10875


def _scan_seed_stream(query, target):
    """All (qidx, qpos, tpos) seeds a Seeder emits for one target."""
    from exonerate_tpu.seeds.seeder import Seeder
    from exonerate_tpu.seeds.hsp import Comparison
    param = HspParam(Match(MatchType.DNA2DNA, MatchArgs()), HspArgs())
    got = []
    comps = []
    seeder = Seeder({"dna": param}, comps.append)
    seeder.add_query(query)
    # capture the raw emission through the batch interface
    loader = seeder.loaders["dna"]
    orig_scan = loader.scan_target

    def spy(target_seq, match, emit, emit_batch=None):
        def spy_emit(ld, qidx, qpos, tpos):
            got.append((qidx, int(qpos), int(tpos)))
            emit(ld, qidx, qpos, tpos)

        def spy_batch(ld, qidx_arr, qpos_arr, tpos_arr):
            got.extend(zip(qidx_arr.tolist(), qpos_arr.tolist(),
                           tpos_arr.tolist()))
            if emit_batch is not None:
                emit_batch(ld, qidx_arr, qpos_arr, tpos_arr)

        return orig_scan(target_seq, match, spy_emit,
                         spy_batch if emit_batch is not None else None)

    loader.scan_target = spy
    seeder.add_target(target)
    return got


def test_scan_memo_content_keyed():
    """The seeder's cross-run memo must key on residue CONTENT: a
    same-length target differing in one base yields different seeds,
    and identical content (fresh objects) yields identical seeds."""
    q, t = make_pair()
    first = _scan_seed_stream(q, t)
    assert first
    # fresh objects, same content: identical stream (memo hit or not)
    q2 = Sequence("q", None, str(q), q.alphabet)
    t2 = Sequence("t", None, str(t), t.alphabet)
    assert _scan_seed_stream(q2, t2) == first
    # one mutated base inside a seeded region: stream must change
    data = bytearray(str(t), "ascii")
    pos = 320
    data[pos] = ord("A") if data[pos] != ord("A") else ord("C")
    t3 = Sequence("t", None, bytes(data).decode(), t.alphabet)
    assert _scan_seed_stream(q, t3) != first
    # vectorized emission matches the brute-force word join
    expect = [(0, qp, tp) for qp, tp in collect_seeds(q, t)]
    assert sorted(first) == sorted(expect)
