"""Word neighbourhoods (BLAST-style).

Equivalent of the reference WordHood
(ref: src/comparison/wordhood.{h,c}): all words within a substitution-score
dropoff of a query word.  Created per match class only when the reference
would (use_dropoff with wordlimit==0 disables it — so DNA seeding is
exact-word by default, ref: HSP_Param_refresh_wordhood, hspset.c:145-167).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..submat import SYMBOL_INDEX
from ..model.match import MatchType
from .hsp import HspParam

DNA_MEMBERS = "ACGT"
PROTEIN_MEMBERS = "ARNDCQEGHILKMFPSTWYUV*"


class WordHood:
    def __init__(self, members: str, score_matrix: np.ndarray,
                 limit: int, use_dropoff: bool, wordlen: int):
        self.members = members
        self.n = len(members)
        self.m = score_matrix  # [n, n] member x member scores
        self.limit = limit
        self.use_dropoff = use_dropoff
        self.wordlen = wordlen
        self._cache: dict[int, list[int]] = {}

    @classmethod
    def for_param(cls, param: HspParam) -> Optional["WordHood"]:
        if param.args.use_word_dropoff and not param.word_limit:
            return None
        match = param.match
        members = (DNA_MEMBERS if match.type == MatchType.DNA2DNA
                   else PROTEIN_MEMBERS)
        sub = (match.mas.dna_submat if match.type == MatchType.DNA2DNA
               else match.mas.protein_submat)
        idx = np.array([SYMBOL_INDEX[ord(c)] for c in members])
        m = sub.matrix[np.ix_(idx, idx)]
        return cls(members, m, param.word_limit,
                   param.args.use_word_dropoff, param.wordlen)

    def _unpack(self, packed: int) -> list[int]:
        out = []
        for _ in range(self.wordlen):
            out.append(packed % self.n)
            packed //= self.n
        out.reverse()
        return out

    def neighbours(self, packed: int) -> list[int]:
        """All packed words scoring >= threshold against `packed`
        (ref: WordHood_traverse, wordhood.c:321-341)."""
        if packed in self._cache:
            return self._cache[packed]
        word = self._unpack(packed)
        W = self.wordlen
        self_score = int(sum(self.m[c, c] for c in word))
        threshold = (self_score - self.limit if self.use_dropoff
                     else self.limit)
        from .. import native
        nat = native.wordhood_neighbours(self.m, word, threshold)
        if nat is not None:
            self._cache[packed] = nat
            return nat
        # suffix max bounds for pruning
        col_max = self.m.max(axis=1)
        suffix_max = np.zeros(W + 1, dtype=np.int64)
        for i in range(W - 1, -1, -1):
            suffix_max[i] = suffix_max[i + 1] + col_max[word[i]]
        out: list[int] = []

        def dfs(pos: int, score: int, acc: int):
            if pos == W:
                if score >= threshold:
                    out.append(acc)
                return
            row = self.m[word[pos]]
            bound = threshold - score - int(suffix_max[pos + 1])
            for c in range(self.n):
                s = int(row[c])
                if s >= bound:
                    dfs(pos + 1, score + s, acc * self.n + c)

        dfs(0, 0, 0)
        self._cache[packed] = out
        return out
