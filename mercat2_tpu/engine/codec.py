"""Symbol codecs: map raw sequence bytes <-> dense b-bit codes.

The device count engine works on dense integer codes, not raw bytes. A
:class:`Codec` assigns each distinct symbol byte a code in ascending byte
order, so that the numeric order of packed k-mer keys equals the
lexicographic (byte) order of the k-mer strings. This is what lets the
device-side sort directly produce the reference's output order
(``sorted(kmers.items())`` at /root/reference/bin/mercat2.py:132) without a
host-side re-sort.

Unlike classic 2-bit-only k-mer tools, codecs here are *data-driven*: the
reference counts raw string k-mers case-sensitively, including ``N`` and
ambiguity codes (/root/reference/lib/mercat2_kmers.py:56-69), so the codec
must represent whatever bytes actually occur. Clean uppercase DNA gets the
fast 2-bit codec; anything else widens to 3..8 bits per symbol.

Record separators are *out of band*: the host-side packed stream stores the
value ``codec.sentinel == S`` at separator/padding positions (it fits in the
uint8 stream even though it does not fit in ``bits`` bits); the device kernel
detects separators with ``code >= S`` and masks windows that contain one.
This keeps ``bits == ceil(log2(S))`` minimal, e.g. true 2-bit DNA packing.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "Codec", "DNA_CODEC", "PROTEIN_CODEC", "codec_for_bytes", "alphabet_of",
    "canonical_codec",
]


@dataclasses.dataclass(frozen=True)
class Codec:
    """Bidirectional map between symbol bytes and dense codes.

    Attributes:
        symbols: sorted uint8 array of the distinct symbol byte values.
        bits: bits per symbol ``b`` with ``len(symbols) <= 2**bits``.
    """

    symbols: np.ndarray  # uint8[S], sorted ascending
    bits: int

    @property
    def size(self) -> int:
        return int(self.symbols.shape[0])

    @property
    def sentinel(self) -> int:
        """Out-of-band separator/pad value stored in the uint8 code stream."""
        return self.size

    def __post_init__(self):
        s = np.asarray(self.symbols, dtype=np.uint8)
        if s.ndim != 1 or s.size == 0:
            raise ValueError("codec needs a non-empty 1-D symbol array")
        if not np.all(s[1:] > s[:-1]):
            raise ValueError("codec symbols must be strictly ascending")
        if self.size > (1 << self.bits):
            raise ValueError(f"{self.size} symbols do not fit in {self.bits} bits")
        if self.size > 255:
            raise ValueError("at most 255 distinct symbols supported")
        object.__setattr__(self, "symbols", s)

    def lut_encode(self) -> np.ndarray:
        """256-entry byte->code table; unknown bytes map to the sentinel."""
        lut = np.full(256, self.sentinel, dtype=np.uint8)
        lut[self.symbols] = np.arange(self.size, dtype=np.uint8)
        return lut

    def encode(self, data: np.ndarray) -> np.ndarray:
        """uint8 bytes -> uint8 codes (unknown bytes become the sentinel)."""
        return self.lut_encode()[data]

    def decode(self, codes: np.ndarray) -> np.ndarray:
        """uint8/int codes -> uint8 bytes. Sentinels are invalid input."""
        return self.symbols[codes]

    def covers(self, present: np.ndarray) -> bool:
        """True if every byte value in `present` has a code."""
        return bool(np.all(np.isin(present, self.symbols)))

    def words_for_k(self, k: int) -> int:
        """32-bit words per packed k-mer key.

        One extra tie-break word is added when ``k*bits`` exactly fills the
        payload words, so that the all-ones "invalid window" marker can never
        collide with a real key (e.g. ``TTTT...T`` under 2-bit DNA).
        """
        payload = max(1, -(-(k * self.bits) // 32))
        if k * self.bits == 32 * payload:
            payload += 1
        return payload


def _codec_from_ascii(s: str, bits: int) -> Codec:
    return Codec(np.sort(np.frombuffer(s.encode(), dtype=np.uint8)), bits)


#: Uppercase unambiguous DNA: true 2-bit packing (k<=16 in one word).
DNA_CODEC = _codec_from_ascii("ACGT", 2)

#: The 26 uppercase letters (covers the 25 amino-acid codes appearing in the
#: reference's metric tables, /root/reference/lib/mercat2_metrics.py:104-130).
PROTEIN_CODEC = _codec_from_ascii("ABCDEFGHIJKLMNOPQRSTUVWXYZ", 5)


def canonical_codec(present: np.ndarray) -> Codec | None:
    """A canonical codec covering the alphabet, or None.

    The pipeline's uniform count path (engine.counter.dispatch_packed_uniform)
    compiles ONE device program per (k, codec) family; shrinking the codec
    family to two canonical members keeps a run's compiled programs few,
    at the cost of an occasional spare key bit. Uppercase ACGT data maps to the
    2-bit DNA codec, anything A-Z to the 5-bit protein codec; unusual
    alphabets (ambiguity bytes, lowercase, digits) keep data-driven codecs.
    Wider-than-needed codecs never change results: codes are simply sparse.
    """
    present = np.asarray(present, dtype=np.uint8)
    if present.size == 0:
        return DNA_CODEC
    if DNA_CODEC.covers(present):
        return DNA_CODEC
    if PROTEIN_CODEC.covers(present):
        return PROTEIN_CODEC
    return None


def alphabet_of(data: np.ndarray) -> np.ndarray:
    """Distinct byte values present in `data` (sorted uint8)."""
    if data.size == 0:
        return np.zeros(0, dtype=np.uint8)
    hist = np.bincount(data, minlength=256)
    return np.nonzero(hist)[0].astype(np.uint8)


def codec_for_alphabet(present: np.ndarray, prefer: Codec | None = None) -> Codec:
    """Narrowest codec covering the given sorted uint8 alphabet."""
    present = np.asarray(present, dtype=np.uint8)
    if prefer is not None and (present.size == 0 or prefer.covers(present)):
        return prefer
    if present.size == 0:
        return DNA_CODEC
    size = int(present.size)
    bits = max(1, int(np.ceil(np.log2(size))))
    return Codec(present, bits)


def codec_for_bytes(data: np.ndarray, prefer: Codec | None = None) -> Codec:
    """Build the narrowest codec covering all bytes in `data`.

    If `prefer` is given and covers the data, it is returned unchanged (so
    chunks of one sample can share a codec and merge numerically).
    """
    return codec_for_alphabet(alphabet_of(data), prefer)
