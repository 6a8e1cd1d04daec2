"""HSPs: seeding, x-drop extension, sets.

Equivalent of the reference HSPset module
(ref: src/comparison/hspset.{h,c}).  The per-seed x-drop extension
(ref: HSP_extend, hspset.c:748-815) is reformulated as vectorized prefix
ops over the whole diagonal (cumsum + running max + first-failure scan),
so each extension is a handful of NumPy vector ops instead of a scalar
loop — the same formulation the batched JAX kernel uses.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..alphabet import IS_SOFTMASKED
from ..submat import SYMBOL_INDEX
from ..seqio import Sequence
from ..model.match import Match, MatchType
from ..engine.region import Region


@dataclass
class HspArgs:
    """HSP options (ref: HSP_ArgumentSet, hspset.c:23-89)."""
    seed_repeat: int = 1
    dna_wordlen: int = 12
    protein_wordlen: int = 6
    codon_wordlen: int = 12
    dna_hsp_dropoff: int = 30
    protein_hsp_dropoff: int = 20
    codon_hsp_dropoff: int = 40
    dna_hsp_threshold: int = 75
    protein_hsp_threshold: int = 30
    codon_hsp_threshold: int = 50
    dna_word_limit: int = 0
    protein_word_limit: int = 4
    codon_word_limit: int = 4
    geneseed_threshold: int = 0
    geneseed_repeat: int = 3
    filter_threshold: int = 0  # --hspfilter
    use_word_dropoff: bool = True


class HspParam:
    """Per-match-class seeding parameters (ref: HSP_Param,
    hspset.h:140-156)."""

    def __init__(self, match: Match, args: Optional[HspArgs] = None):
        self.match = match
        self.args = args or HspArgs()
        a = self.args
        mt = match.type
        if mt == MatchType.DNA2DNA:
            self.wordlen = a.dna_wordlen
            self.dropoff = a.dna_hsp_dropoff
            self.threshold = a.dna_hsp_threshold
            self.word_limit = a.dna_word_limit
        elif mt == MatchType.CODON2CODON:
            self.wordlen = a.codon_wordlen
            self.dropoff = a.codon_hsp_dropoff
            self.threshold = a.codon_hsp_threshold
            self.word_limit = a.codon_word_limit
        else:
            self.wordlen = a.protein_wordlen
            self.dropoff = a.protein_hsp_dropoff
            self.threshold = a.protein_hsp_threshold
            self.word_limit = a.protein_word_limit
        self.seed_repeat = a.seed_repeat
        self.filter_threshold = a.filter_threshold

    def swap(self) -> "HspParam":
        """Query/target-mirrored parameters (ref: HSP_Param_swap,
        hspset.c): same class thresholds, mirrored match."""
        return HspParam(self.match.swap(), self.args)

    @property
    def seedlen(self) -> int:
        # (ref: HSP_Param_set_wordlen, hspset.c:110-117)
        return self.wordlen // self.match.advance_query


@dataclass
class HSP:
    """(ref: HSP, hspset.h:67-74)."""
    query_start: int
    target_start: int
    length: int
    score: int
    cobs: int = 0

    def query_end(self, qadv: int) -> int:
        return self.query_start + self.length * qadv

    def target_end(self, tadv: int) -> int:
        return self.target_start + self.length * tadv

    def diagonal(self, qadv: int, tadv: int) -> int:
        return self.target_start * qadv - self.query_start * tadv


_SM_MEMO: dict = {}


def _softmask_of(seq) -> np.ndarray:
    """Memoized IS_SOFTMASKED gather (an HspSet is built per
    (query, target, class) — re-gathering a 1 Mb target per query was
    ~0.25 s of a serving stream)."""
    key = id(seq)
    hit = _SM_MEMO.get(key)
    if hit is not None and hit[0] is seq:
        return hit[1]
    v = IS_SOFTMASKED[seq.data]
    if len(_SM_MEMO) > 64:
        _SM_MEMO.clear()
    _SM_MEMO[key] = (seq, v)
    return v


class HspSet:
    """A set of HSPs for one (query, target, match-class)
    (ref: HSPset, hspset.h:191-224)."""

    def __init__(self, query: Sequence, target: Sequence,
                 param: HspParam):
        self.query = query
        self.target = target
        self.param = param
        self.hsps: list[HSP] = []
        self.is_finalised = False
        m = param.match
        self.qadv = m.advance_query
        self.tadv = m.advance_target
        # horizon: [section][qframe][tframe] -> (last_target_end,
        # repeat_count, diag_mailbox) (ref: hspset.c:933-997); note the
        # reference aliases diagonals modulo query length on purpose.
        self._horizon: dict = {}
        # per-position score rows cached for vectorized diagonal gathers
        self._qi = m._row_indices(query, m.advance_query)
        self._ti = m._row_indices(target, m.advance_target)
        self._mat = m.submat.matrix
        self._q_mask = _softmask_of(query)
        self._t_mask = _softmask_of(target)
        self._forbid_masked = (m.mas.softmask_query
                               or m.mas.softmask_target)
        ann = query.annotation
        self._cds_veto = None
        if ann is not None and query.alphabet.type.value == "dna":
            n = len(query)
            if m.type == MatchType.DNA2DNA:
                bad = np.zeros(n, dtype=bool)
                bad[ann.cds_start:ann.cds_start + ann.cds_length] = True
                self._cds_veto = bad
            elif m.type == MatchType.CODON2CODON:
                pos = np.arange(n)
                self._cds_veto = ((pos < ann.cds_start)
                                  | (pos >= ann.cds_start + ann.cds_length)
                                  | ((pos % 3) != (ann.cds_start % 3)))

    # -- scoring along a diagonal -----------------------------------------

    def _diag_scores(self, qpos: np.ndarray, tpos: np.ndarray) -> np.ndarray:
        s = self._mat[self._qi[qpos], self._ti[tpos]]
        if self._cds_veto is not None:
            s = np.where(self._cds_veto[qpos], -987654321, s)
        return s

    def score_at(self, qpos: int, tpos: int) -> int:
        return int(self._diag_scores(np.array([qpos]),
                                     np.array([tpos]))[0])

    # -- x-drop extension (ref: HSP_extend, hspset.c:748-815) -------------

    def _extend_dir(self, s0: int, qpos0: int, tpos0: int, sign: int,
                    forbid_masked: bool) -> tuple[int, int]:
        """Extend from score s0 starting at the first new position
        (qpos0, tpos0) stepping by sign*(qadv, tadv).
        Returns (maxext, maxscore)."""
        qadv, tadv = self.qadv * sign, self.tadv * sign
        if sign < 0:
            # left: positions valid while qpos >= 0 (ref loop condition)
            n_q = qpos0 // self.qadv + 1 if qpos0 >= 0 else 0
            n_t = tpos0 // self.tadv + 1 if tpos0 >= 0 else 0
        else:
            # right: valid while qpos + qadv <= len (whole unit fits)
            n_q = max(0, (len(self.query) - qpos0) // self.qadv)
            n_t = max(0, (len(self.target) - tpos0) // self.tadv)
        n = min(n_q, n_t)
        if n <= 0:
            return 0, s0
        qpos = qpos0 + np.arange(n) * qadv
        tpos = tpos0 + np.arange(n) * tadv
        if forbid_masked:
            # stop before first masked position
            masked = self._q_mask[qpos] | self._t_mask[tpos]
            first = int(np.argmax(masked)) if masked.any() else n
            if first == 0:
                return 0, s0
            qpos, tpos = qpos[:first], tpos[:first]
            n = first
        m = self._diag_scores(qpos, tpos).astype(np.int64)
        cum = s0 + np.cumsum(m)
        runmax = np.maximum.accumulate(np.maximum(cum, s0))
        runmax = np.maximum(runmax, s0)
        bad = (cum < runmax) & ((cum < 0)
                               | (runmax - cum >= self.param.dropoff))
        stop = int(np.argmax(bad)) if bad.any() else n
        if stop == 0:
            return 0, s0
        sub = cum[:stop]
        subrun = runmax[:stop]
        hits = np.nonzero(sub == subrun)[0]
        if len(hits) == 0:
            return 0, s0
        maxext = int(hits[-1]) + 1
        return maxext, int(subrun[stop - 1])

    def _extend(self, h: HSP, forbid_masked: bool):
        qadv, tadv = self.qadv, self.tadv
        maxext, maxscore = self._extend_dir(
            h.score, h.query_start - qadv, h.target_start - tadv, -1,
            forbid_masked)
        h.query_start -= maxext * qadv
        h.target_start -= maxext * tadv
        h.length += maxext
        maxext, maxscore = self._extend_dir(
            maxscore, h.query_end(qadv), h.target_end(tadv), +1,
            forbid_masked)
        h.length += maxext
        h.score = maxscore

    def _trim_ends(self, h: HSP):
        """(ref: HSP_trim_ends, hspset.c:852-880)."""
        while h.length > 0 and self.score_at(h.query_start,
                                             h.target_start) <= 0:
            h.query_start += self.qadv
            h.target_start += self.tadv
            h.length -= 1
        while h.length > 0:
            qp = h.query_end(self.qadv) - self.qadv
            tp = h.target_end(self.tadv) - self.tadv
            if self.score_at(qp, tp) > 0:
                break
            h.length -= 1

    def _init_score(self, h: HSP):
        if h.length == 0:
            h.score = 0
            return
        qpos = h.query_start + np.arange(h.length) * self.qadv
        tpos = h.target_start + np.arange(h.length) * self.tadv
        h.score = int(self._diag_scores(qpos, tpos).sum())
        if h.score < 0:
            self._bad_seed_fatal(h)

    def _bad_seed_fatal(self, h: HSP):
        """A trimmed seed word scoring negative aborts the reference
        (ref: HSP_init, hspset.c:740-743) after dumping the HSP to
        stdout.  The dump's interior (HSP info block + alignment
        panels) embeds a STACK POINTER (`HSP info (0x7ffc...)`) so two
        reference runs differ byte-for-byte there; we emit the
        deterministic frame of the dump (the draw_hsp line and the
        sugar line) and the FATAL, and the fuzzer normalizes the
        nondeterministic interior on both sides."""
        import sys as _sys
        print(f'draw_hsp({h.query_start}, {h.target_start}, '
              f'{h.length}, {h.cobs}, {self.qadv}, {self.tadv}, '
              f'"Bad HSP seed")', file=_sys.stdout)
        qc = getattr(self.query, "strand", "+") or "+"
        tc = getattr(self.target, "strand", "+") or "+"
        print(f'sugar: {self.query.id} {h.query_start} '
              f'{h.length * self.qadv} {qc} {self.target.id} '
              f'{h.target_start} {h.length * self.tadv} {tc} '
              f'{h.score}', file=_sys.stdout)
        _sys.stdout.flush()
        _sys.stderr.write(f"** FATAL ERROR **: Initial HSP score "
                          f"[{h.score}] less than zero\nexiting ...\n")
        raise SystemExit(1)

    def find_cobs(self, h: HSP) -> int:
        """Centre offset by score (ref: HSP_find_cobs, hspset.c:426-441)."""
        qpos = h.query_start + np.arange(h.length) * self.qadv
        tpos = h.target_start + np.arange(h.length) * self.tadv
        cum = np.cumsum(self._diag_scores(qpos, tpos))
        half = h.score >> 1
        hit = np.nonzero(cum >= half)[0]
        return int(hit[0]) if len(hit) else h.length

    # -- seeding (ref: HSPset_seed_hsp, hspset.c:933-997) -----------------

    def seed(self, query_start: int, target_start: int):
        assert not self.is_finalised
        qadv, tadv = self.qadv, self.tadv
        diag_pos = target_start * qadv - query_start * tadv
        qframe = query_start % qadv
        tframe = target_start % tadv
        qlen = len(self.query)
        section = (diag_pos + qlen) % qlen
        key = (section, qframe, tframe)
        h_end, h_count, h_diag = self._horizon.get(key, (0, 0, None))
        if self.param.seed_repeat > 1 and h_diag != diag_pos + qlen:
            h_end, h_count, h_diag = 0, 0, diag_pos + qlen
        if target_start < h_end:
            return
        if self.param.seed_repeat > 1:
            h_count += 1
            if h_count < self.param.seed_repeat:
                self._horizon[key] = (h_end, h_count, h_diag)
                return
            h_count = 0
        h = HSP(query_start, target_start, self.param.seedlen, 0)
        self._trim_ends(h)
        self._init_score(h)
        if self._forbid_masked:
            self._extend(h, True)
            if h.score < self.param.threshold:
                self._horizon[key] = (h.target_end(tadv), h_count, h_diag)
                return
        self._extend(h, False)
        self._store(h)
        self._horizon[key] = (h.target_end(tadv), h_count, h_diag)

    def seed_qy_sorted(self, pairs: list[tuple[int, int]]):
        """Seed a server word-seed list with the page-horizon variant
        (ref: HSPset_seed_all_qy_sorted, hspset.c:1322-1410).  Unlike
        the streaming seed() horizon (sectioned modulo QUERY length,
        keeps target ends), this one sections the diagonal modulo
        TARGET length into 1024-wide pages, clears each slot when its
        page changes (generation trick), and compares/stores HSP
        *query* ends.  `pairs` must already be in qy_page_order."""
        PAGE_BITS = 10                      # hspset.c:1240
        qadv, tadv = self.qadv, self.tadv
        tlen = len(self.target)
        horizon: dict = {}                  # (page_pos,qf,tf) -> state
        for query_start, target_start in pairs:
            diag_pos = target_start * qadv - query_start * tadv
            section = (diag_pos + tlen) % tlen
            page = section >> PAGE_BITS
            page_pos = section - (page << PAGE_BITS)
            key = (page_pos, query_start % qadv, target_start % tadv)
            val, last_page, rep = horizon.get(key, (0, -1, 0))
            if last_page != page:
                val, rep = 0, 0
            if query_start < val:
                horizon[key] = (val, page, rep)
                continue
            if self.param.seed_repeat > 1:
                rep += 1
                if rep < self.param.seed_repeat:
                    horizon[key] = (val, page, rep)
                    continue
                rep = 0
            h = HSP(query_start, target_start, self.param.seedlen, 0)
            self._trim_ends(h)
            self._init_score(h)
            if self._forbid_masked:
                self._extend(h, True)
                if h.score < self.param.threshold:
                    horizon[key] = (h.query_end(qadv), page, rep)
                    continue
            self._extend(h, False)
            self._store(h)
            horizon[key] = (h.query_end(qadv), page, rep)

    def seed_batch(self, seeds: list[tuple[int, int]]):
        """Process a presorted seed list, preferring the native C++
        seeding machine (native/seedlib.cpp) and falling back to the
        per-seed Python path."""
        if not len(seeds):
            return
        if self.param.filter_threshold or self.is_finalised:
            for q, t in np.asarray(seeds, dtype=np.int64).tolist():
                self.seed(q, t)
            return
        from .. import native
        if native.get_lib() is None or self.hsps or self._horizon:
            for q, t in np.asarray(seeds, dtype=np.int64).tolist():
                self.seed(q, t)
            return
        arr = np.asarray(seeds, dtype=np.int64)
        res = native.seed_all(
            self._qi, self._ti, self._mat,
            self._cds_veto,
            self._q_mask if self._forbid_masked else None,
            self._t_mask if self._forbid_masked else None,
            self._forbid_masked, self.qadv, self.tadv,
            self.param.seedlen, self.param.dropoff,
            self.param.threshold, self.param.seed_repeat,
            arr[:, 0], arr[:, 1])
        if res is None:
            for q, t in seeds:
                self.seed(q, t)
            return
        if isinstance(res[0], str):       # ("bad_seed", q, t, len, score)
            _, bq, bt, blen, bscore = res
            bad = HSP(bq, bt, blen, bscore)
            self._bad_seed_fatal(bad)
        qs, ts, lens, scores, cobs = res
        for k in range(len(qs)):
            self.hsps.append(HSP(int(qs[k]), int(ts[k]), int(lens[k]),
                                 int(scores[k]), int(cobs[k])))
        self.is_finalised = True

    def add_known_hsp(self, query_start: int, target_start: int,
                      length: int):
        """(ref: HSPset_add_known_hsp) — used by the server client path."""
        h = HSP(query_start, target_start, length, 0)
        self._init_score(h)
        self._store(h)

    def _store(self, h: HSP):
        """(ref: HSP_store, hspset.c:888-927); the --hspfilter per-cobs
        PQueue filter keeps the best filter_threshold HSPs per query
        cobs position."""
        if h.score < self.param.threshold:
            return
        if self.param.filter_threshold:
            h.cobs = self.find_cobs(h)
        self.hsps.append(h)

    def finalise(self):
        """(ref: HSPset_finalise, hspset.c:1123-1150)."""
        if self.is_finalised:
            return self
        self.is_finalised = True
        if self.param.filter_threshold and self.hsps:
            # keep best filter_threshold per query cobs position
            by_pos: dict[int, list[HSP]] = {}
            for h in self.hsps:
                pos = h.query_start + h.cobs * self.qadv
                by_pos.setdefault(pos, []).append(h)
            kept: list[HSP] = []
            for pos in sorted(by_pos):
                group = sorted(by_pos[pos], key=lambda x: x.score,
                               reverse=True)[:self.param.filter_threshold]
                # reference pops ascending from the PQueue
                kept.extend(sorted(group, key=lambda x: x.score))
            self.hsps = kept
        else:
            for h in self.hsps:
                h.cobs = self.find_cobs(h)
        return self

    @property
    def is_empty(self) -> bool:
        return not self.hsps

    def filter_ungapped(self):
        """Overlap filter for 3:3 HSPs on the same diagonal in different
        frames (ref: HSPset_filter_ungapped, hspset.c:1187-1240)."""
        if len(self.hsps) <= 1 or self.qadv != 3 or self.tadv != 3:
            return
        self.hsps.sort(key=lambda h: (h.diagonal(self.qadv, self.tadv),
                                      h.query_start))
        out: list[HSP] = []
        prev = self.hsps[0]
        del_prev = False
        for curr in self.hsps[1:]:
            del_curr = False
            if (prev.diagonal(self.qadv, self.tadv)
                    == curr.diagonal(self.qadv, self.tadv)
                    and prev.query_end(self.qadv) > curr.query_start):
                score = self._score_overlap(prev, curr)
                if (score << 1) > (curr.score + prev.score):
                    if prev.score < curr.score:
                        del_prev = True
                    else:
                        del_curr = True
            if not del_prev:
                out.append(prev)
            prev = curr
            del_prev = del_curr
        if not del_prev:
            out.append(prev)
        self.hsps = out

    def _score_overlap(self, left: HSP, right: HSP) -> int:
        """Sum of BOTH HSPs' match scores over the overlapped region
        (ref: HSP_score_overlap, hspset.c:1164-1184: the left HSP's
        positions walking back from its end, plus the right HSP's
        positions walking forward from its start — the doubled total is
        then compared against score_left + score_right)."""
        score = 0
        qp = left.query_end(self.qadv) - self.qadv
        tp = left.target_end(self.tadv) - self.tadv
        while qp >= right.query_start:
            score += self.score_at(qp, tp)
            qp -= self.qadv
            tp -= self.tadv
        qp = right.query_start
        tp = right.target_start
        while qp < left.query_end(self.qadv) - self.qadv:
            score += self.score_at(qp, tp)
            qp += self.qadv
            tp += self.tadv
        return score


class Comparison:
    """Bundle of up to 3 HSP sets per pair (ref: src/comparison/
    comparison.h:32-74)."""

    def __init__(self, query: Sequence, target: Sequence,
                 dna: Optional[HspSet] = None,
                 protein: Optional[HspSet] = None,
                 codon: Optional[HspSet] = None):
        self.query = query
        self.target = target
        self.dna_hspset = dna
        self.protein_hspset = protein
        self.codon_hspset = codon

    def hspsets(self):
        return [h for h in (self.dna_hspset, self.protein_hspset,
                            self.codon_hspset) if h is not None]

    @property
    def has_hsps(self) -> bool:
        return any(not h.is_empty for h in self.hspsets())

    def finalise(self):
        for h in self.hspsets():
            h.finalise()

    def swap(self):
        """Exchange query/target roles in place (ref: Comparison_swap,
        comparison.c:214-235): mirror the params, swap sequences and
        every HSP's coordinates, and rebuild the per-set score caches."""
        self.query, self.target = self.target, self.query
        for hs in self.hspsets():
            hs.query, hs.target = self.query, self.target
            hs.param = hs.param.swap()
            m = hs.param.match
            hs.qadv, hs.tadv = m.advance_query, m.advance_target
            for h in hs.hsps:
                h.query_start, h.target_start = (h.target_start,
                                                 h.query_start)
            hs._qi = m._row_indices(hs.query, m.advance_query)
            hs._ti = m._row_indices(hs.target, m.advance_target)
