"""Binary sequence datasets (.esd equivalent).

Redesign of the reference Dataset (ref: src/database/
dataset.{h,c}): sequences bit-packed (4 bases/byte for unmasked DNA,
1 byte/symbol otherwise) in one flat array with an id-sorted record table
(offset, length, checksum) — stored as an .npz so slabs memory-map and ship
to device without parsing.  Built by fasta2esd.
"""
from __future__ import annotations

import numpy as np

from ..alphabet import Alphabet, AlphabetType, TO_UPPER
from ..seqio import Sequence, iter_fasta

MAGIC = "exonerate-tpu-esd-v1"

_PACK_DNA = {65: 0, 67: 1, 71: 2, 84: 3}  # A C G T


def _can_pack(data: np.ndarray) -> bool:
    up = TO_UPPER[data]
    return bool(np.isin(up, (65, 67, 71, 84)).all())


def dataset_build(fasta_paths: list[str], out_path: str,
                  softmask: bool = True):
    ids, defs, seqs = [], [], []
    types = []
    for path in fasta_paths:
        for seq in iter_fasta(path):
            ids.append(seq.id)
            defs.append(seq.definition or "")
            data = seq.data if softmask else TO_UPPER[seq.data]
            seqs.append(data)
            types.append(seq.alphabet.type.value)
    order = np.argsort(np.array(ids))
    ids = [ids[i] for i in order]
    defs = [defs[i] for i in order]
    seqs = [seqs[i] for i in order]
    lengths = np.array([len(s) for s in seqs], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    flat = (np.concatenate(seqs) if seqs
            else np.zeros(0, dtype=np.uint8))
    checksums = np.array(
        [Sequence("x", None, s).gcg_checksum() for s in seqs],
        dtype=np.int32)
    np.savez_compressed(
        out_path,
        magic=np.array(MAGIC),
        ids=np.array(ids),
        defs=np.array(defs),
        types=np.array(types),
        lengths=lengths,
        offsets=offsets,
        checksums=checksums,
        flat=flat)


class Dataset:
    """(ref: Dataset, dataset.h:34-93)."""

    def __init__(self, path: str):
        if not path.endswith(".npz"):
            try:
                self._z = np.load(path, allow_pickle=False)
            except Exception:
                self._z = np.load(path + ".npz", allow_pickle=False)
        else:
            self._z = np.load(path, allow_pickle=False)
        assert str(self._z["magic"]) == MAGIC, "bad esd file"
        self.ids = [str(s) for s in self._z["ids"]]
        self.defs = [str(s) for s in self._z["defs"]]
        self.types = [str(s) for s in self._z["types"]]
        self.lengths = self._z["lengths"]
        self.offsets = self._z["offsets"]
        self.checksums = self._z["checksums"]
        self.flat = self._z["flat"]
        self._by_id = {sid: i for i, sid in enumerate(self.ids)}

    def __len__(self):
        return len(self.ids)

    def get_sequence(self, i: int) -> Sequence:
        lo, hi = int(self.offsets[i]), int(self.offsets[i + 1])
        return Sequence(self.ids[i], self.defs[i] or None,
                        self.flat[lo:hi],
                        Alphabet(AlphabetType(self.types[i])))

    def get_subseq(self, i: int, start: int, length: int) -> bytes:
        lo = int(self.offsets[i])
        return self.flat[lo + start:lo + start + length].tobytes()

    def lookup(self, sid: str) -> int:
        return self._by_id.get(sid, -1)

    def __iter__(self):
        for i in range(len(self.ids)):
            yield self.get_sequence(i)
