"""Alphabets and symbol filter tables.

Equivalent of the reference Alphabet module
(ref: src/sequence/alphabet.{h,c}): DNA/protein alphabets with 256-entry
filter tables (masked/unmasked/complement/clean) as NumPy uint8 arrays so
whole sequences filter as one vectorized gather.
"""
from __future__ import annotations

import enum
import numpy as np


class AlphabetType(enum.Enum):
    UNKNOWN = "unknown"
    DNA = "dna"
    PROTEIN = "protein"


DNA_MEMBERS = b"ACGTN"
# IUPAC ambiguity codes accepted in DNA input
DNA_AMBIG = b"ACGTNRYSWKMBDHV"
PROTEIN_MEMBERS = b"ARNDCQEGHILKMFPSTWYVBZX*"

_COMPLEMENT_PAIRS = {
    # IUPAC complement mapping (bitwise complement of the base sets)
    "A": "T", "C": "G", "G": "C", "T": "A", "U": "A",
    "R": "Y", "Y": "R", "S": "S", "W": "W", "K": "M", "M": "K",
    "B": "V", "V": "B", "D": "H", "H": "D", "N": "N", "X": "X",
    "-": "-",
}


def _make_table(fn) -> np.ndarray:
    out = np.arange(256, dtype=np.uint8)
    for i in range(256):
        out[i] = fn(i)
    return out


def _complement_char(i: int) -> int:
    c = chr(i)
    up = c.upper()
    comp = _COMPLEMENT_PAIRS.get(up)
    if comp is None:
        return i
    return ord(comp.lower()) if c.islower() else ord(comp)


# 256-entry tables, applied by numpy fancy-indexing over uint8 sequences.
TO_UPPER = _make_table(
    lambda i: i - 32 if ord("a") <= i <= ord("z") else i)
TO_LOWER = _make_table(
    lambda i: i + 32 if ord("A") <= i <= ord("Z") else i)
COMPLEMENT = _make_table(
    lambda i: _complement_char(i) if i < 128 else i)
COMPLEMENT_UPPER = COMPLEMENT[TO_UPPER]


def _is_member_table(members: bytes) -> np.ndarray:
    out = np.zeros(256, dtype=bool)
    for m in members:
        out[m] = True
        out[ord(chr(m).lower())] = True
    return out


IS_DNA_CORE = _is_member_table(DNA_MEMBERS)
IS_DNA = _is_member_table(DNA_AMBIG + b"U-")
IS_PROTEIN = _is_member_table(PROTEIN_MEMBERS + b"U-")
IS_SOFTMASKED = _make_table(
    lambda i: 1 if ord("a") <= i <= ord("z") else 0).astype(bool)
IS_ALPHA = _make_table(
    lambda i: 1 if (ord("a") <= i <= ord("z")
                    or ord("A") <= i <= ord("Z")) else 0).astype(bool)


class Alphabet:
    """An alphabet with vectorized filters.

    The reference keeps per-alphabet 256-entry filter tables and a
    softmask-aware ``is_masked`` check (ref: src/sequence/alphabet.h:50-62);
    here the tables are module-level numpy arrays shared by all instances.
    """

    def __init__(self, atype: AlphabetType, softmasked: bool = False):
        self.type = atype
        self.softmasked = softmasked

    @property
    def is_dna(self) -> bool:
        return self.type == AlphabetType.DNA

    @property
    def is_protein(self) -> bool:
        return self.type == AlphabetType.PROTEIN

    def __repr__(self):
        return f"Alphabet({self.type.value}, softmasked={self.softmasked})"


def guess_type(seq: np.ndarray | bytes, sample: int = 100) -> AlphabetType:
    """Guess DNA vs protein: >85% of the first 100 residues in {A,C,G,T,N}
    implies DNA (ref: doc/man/man1/exonerate.1:158-164, fastadb.c type guess).
    """
    if isinstance(seq, (bytes, bytearray)):
        arr = np.frombuffer(bytes(seq[:sample]), dtype=np.uint8)
    else:
        arr = np.asarray(seq[:sample], dtype=np.uint8)
    arr = arr[IS_ALPHA[arr]]
    if arr.size == 0:
        return AlphabetType.UNKNOWN
    frac = float(np.count_nonzero(IS_DNA_CORE[arr])) / arr.size
    return AlphabetType.DNA if frac > 0.85 else AlphabetType.PROTEIN


def revcomp(seq: np.ndarray) -> np.ndarray:
    """Reverse complement of a uint8 DNA sequence (case preserved)."""
    return COMPLEMENT[seq[::-1]]


def to_bytes(seq: np.ndarray) -> bytes:
    return np.asarray(seq, dtype=np.uint8).tobytes()


def from_str(s: str | bytes) -> np.ndarray:
    if isinstance(s, str):
        s = s.encode()
    return np.frombuffer(s, dtype=np.uint8).copy()
