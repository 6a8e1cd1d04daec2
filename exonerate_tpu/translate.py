"""Genetic-code translation.

Equivalent of the reference Translate module
(ref: src/sequence/translate.{h,c}). Nucleotides map to 4-bit IUPAC sets
("-GARTKWDCSMVYBHN" encoding: one bit per base, reversal == complement), and
the 4096-entry codon->amino-acid table is precomputed so whole-sequence
translation is one vectorized gather: aa = TRANS[nt4[q0] | nt4[q1]<<4 |
nt4[q2]<<8]. Ambiguous codons resolve to the first amino acid whose
redundancy-group mask covers every possible translation (exactly the
reference's aamask algorithm, ref: src/sequence/translate.c:88-116), which
yields 'X' for genuinely ambiguous codons.
"""
from __future__ import annotations

import numpy as np

NT_SET = "-GARTKWDCSMVYBHN"
AA_SET_PIMA = "-ARNDCQEGHILKMFPSTWYV*ablkonihdmcepjfrxX"
AA_SET = "-ARNDCQEGHILKMFPSTWYV*XXXXXXXXXXXXXXXXXX"

# NCBI genetic codes, TCAG order (ref data: src/sequence/translate.c:170-205;
# source: NCBI taxonomy genetic-code tables)
_NCBI_CODES = {
    1: "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    2: "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNKKSS**VVVVAAAADDEEGGGG",
    3: "FFLLSSSSYY**CCWWTTTTPPPPHHQQRRRRIIMMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    4: "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    5: "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNKKSSSSVVVVAAAADDEEGGGG",
    6: "FFLLSSSSYYQQCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    9: "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNNKSSSSVVVVAAAADDEEGGGG",
    10: "FFLLSSSSYY**CCCWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    11: "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    12: "FFLLSSSSYY**CC*WLLLSPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    13: "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNKKSSGGVVVVAAAADDEEGGGG",
    14: "FFLLSSSSYYY*CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNNKSSSSVVVVAAAADDEEGGGG",
    15: "FFLLSSSSYY*QCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    16: "FFLLSSSSYY*LCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    21: "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNNKSSSSVVVVAAAADDEEGGGG",
    22: "FFLLSS*SYY*LCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    23: "FF*LSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
}

# PIMA amino-acid redundancy groups (ref: src/sequence/translate.c:70-74)
_PIMA_GROUPS = [
    "aIV", "bLM", "dFWY", "lND", "kDE", "oEQ",
    "nKR", "iST", "hAG", "cab", "edH", "mlk",
    "pon", "jihP", "fCcd", "rHmpi", "xfrj", "Xx*",
]


def _ncbi_to_internal(code: str) -> str:
    """Reorder an NCBI (TCAG) 64-codon string to the internal GATC bit order
    (ref: src/sequence/translate.c Translate_convert_genetic_code)."""
    assert len(code) == 64
    table = [3, 2, 0, 1]
    out = []
    for a in range(4):
        for b in range(4):
            for c in range(4):
                out.append(code[(table[a] << 4) | (table[b] << 2) | table[c]])
    return "".join(out)


def _build_nt4() -> np.ndarray:
    nt4 = np.zeros(256, dtype=np.int32)
    for i, ch in enumerate(NT_SET):
        nt4[ord(ch)] = i
        nt4[ord(ch.lower())] = i
    nt4[ord("X")] = nt4[ord("x")] = nt4[ord("N")]
    nt4[ord("U")] = nt4[ord("u")] = nt4[ord("T")]
    return nt4


NT4 = _build_nt4()


class GeneticCode:
    """A genetic code with the precomputed 4096-entry ambiguity-aware
    codon->aa table (ref: src/sequence/translate.c:88-116)."""

    def __init__(self, spec: str | int | None = "1"):
        if spec is None:
            code = _ncbi_to_internal(_NCBI_CODES[1])
        elif isinstance(spec, int) or (isinstance(spec, str) and len(spec) <= 2):
            cid = int(spec)
            if cid not in _NCBI_CODES:
                raise ValueError(f"no built-in genetic code with id {cid}")
            code = _ncbi_to_internal(_NCBI_CODES[cid])
        elif isinstance(spec, str) and len(spec) == 64:
            code = _ncbi_to_internal(spec)
        else:
            raise ValueError(f"could not use genetic code {spec!r}")
        self.code = code  # internal GATC-bit-order 64-codon string
        # the 4096-entry ambiguity table is a pure function of the
        # 64-codon string and costs ~60 ms to enumerate; every CLI run
        # rebuilds a GeneticCode, so share tables per code string
        hit = GeneticCode._TABLE_MEMO.get(code)
        if hit is not None:
            self.trans, self.revtrans = hit
        else:
            self._build_tables()
            GeneticCode._TABLE_MEMO[code] = (self.trans, self.revtrans)

    _TABLE_MEMO: dict = {}

    def _build_tables(self):
        aa2d = {ch: i for i, ch in enumerate(AA_SET_PIMA)}
        aamask = np.zeros(len(AA_SET_PIMA), dtype=np.int64)
        for i in range(1, 23):
            aamask[i] = 1 << (i - 1)
        for grp in _PIMA_GROUPS:
            head = aa2d[grp[0]]
            aamask[head] = aamask[aa2d[grp[1]]]
            for ch in grp[2:]:
                aamask[head] |= aamask[aa2d[ch]]
        # exact-codon masks for the 64 unambiguous codons
        codon_mask = np.array(
            [aamask[aa2d[self.code[i]]] for i in range(64)], dtype=np.int64)
        # union of possibilities per ambiguous (x,y,z) in 16^3
        trans = np.zeros(4096, dtype=np.uint8)
        bit = np.arange(4)
        for x in range(16):
            xa = bit[(x >> bit) & 1 == 1]
            for y in range(16):
                yb = bit[(y >> bit) & 1 == 1]
                for z in range(16):
                    zc = bit[(z >> bit) & 1 == 1]
                    if len(xa) and len(yb) and len(zc):
                        combos = ((xa[:, None, None] << 4)
                                  | (yb[None, :, None] << 2)
                                  | zc[None, None, :]).ravel()
                        m = np.bitwise_or.reduce(codon_mask[combos])
                    else:
                        m = 0
                    # first aa whose mask covers the union
                    i = 0
                    while (aamask[i] | m) != aamask[i]:
                        i += 1
                    trans[x | (y << 4) | (z << 8)] = ord(AA_SET[i])
        self.trans = trans  # packed-codon -> ascii aa
        # reverse translation: aa char -> list of codon ids (GATC order)
        rev: dict[str, list[int]] = {}
        for i, aa in enumerate(self.code):
            rev.setdefault(aa, []).append(i)
        self.revtrans = rev

    def codon(self, a: int, b: int, c: int) -> int:
        """Translate one codon given three ascii bases -> ascii amino acid."""
        return int(self.trans[NT4[a] | (NT4[b] << 4) | (NT4[c] << 8)])

    def translate(self, dna: np.ndarray, frame: int = 1) -> np.ndarray:
        """Translate a uint8 DNA array in frame +-1..3 -> uint8 peptide
        (ref: src/sequence/translate.c Translate_sequence)."""
        dna = np.asarray(dna, dtype=np.uint8)
        if 0 < frame < 4:
            sub = dna[frame - 1:]
        elif -4 < frame < 0:
            from .alphabet import COMPLEMENT
            sub = COMPLEMENT[dna[::-1]][-frame - 1:]
        else:
            raise ValueError(f"invalid reading frame {frame}")
        n = len(sub) // 3
        if n == 0:
            return np.zeros(0, dtype=np.uint8)
        cod = sub[:n * 3].reshape(n, 3).astype(np.int32)
        packed = NT4[cod[:, 0]] | (NT4[cod[:, 1]] << 4) | (NT4[cod[:, 2]] << 8)
        return self.trans[packed]

    def translate_str(self, dna: str, frame: int = 1) -> str:
        from .alphabet import from_str
        return self.translate(from_str(dna), frame).tobytes().decode()


_DEFAULT: GeneticCode | None = None


def default_code() -> GeneticCode:
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = GeneticCode("1")
    return _DEFAULT
