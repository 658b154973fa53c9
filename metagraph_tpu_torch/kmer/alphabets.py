"""Alphabet definitions (reference: metagraph/src/kmer/alphabets.hpp:27-150).

Unlike the reference, which keeps two packings per alphabet (a tight 2-bit
one for real k-mers and a 3-bit one with the ``$`` sentinel for the BOSS
table, converted between via ``kmer::transform``), we use the sentinel
alphabet everywhere: codes are ``$``=0, then the real characters from 1.
This removes the lift/transform pass from the construction pipeline
(reference: kmer_transform.hpp:39) at the cost of slightly wider sort keys
— a good trade on TPU where the sort is a dense bandwidth-bound kernel and
extra passes hurt more than extra bits.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np

INVALID_CODE = np.uint8(255)


@dataclass(frozen=True)
class Alphabet:
    name: str
    letters: str              # includes leading '$' sentinel
    bits_per_char: int        # nibble-aligned: 4 or 8
    complement: Tuple[int, ...] = ()   # code -> complement code ('' = none)
    case_sensitive: bool = False       # upper/lower case are distinct codes

    @property
    def size(self) -> int:
        return len(self.letters)

    @property
    def sentinel_code(self) -> int:
        return 0

    def encode_table(self) -> np.ndarray:
        """256-entry byte -> code table; unknown bytes map to INVALID_CODE."""
        tbl = np.full(256, INVALID_CODE, np.uint8)
        for code, ch in enumerate(self.letters):
            tbl[ord(ch)] = code
            if not self.case_sensitive:
                tbl[ord(ch.lower())] = code
        return tbl

    def decode(self, codes) -> str:
        return "".join(self.letters[int(c)] for c in codes)


# DNA: $ A C G T  (reference alphabets.hpp kAlphabetDNA + kBOSS sentinel).
DNA = Alphabet(
    name="DNA",
    letters="$ACGT",
    bits_per_char=4,
    complement=(0, 4, 3, 2, 1),  # $->$  A<->T  C<->G
)

# DNA5: N folded into its own character (reference kAlphabetDNA5); N is its
# own complement.
DNA5 = Alphabet(
    name="DNA5",
    letters="$ACGTN",
    bits_per_char=4,
    complement=(0, 4, 3, 2, 1, 5),
)

# DNACaseSent: case-sensitive DNA — upper and lower case are distinct
# codes (reference kBOSSAlphabetDNACaseSent "$ACGTNacgt",
# alphabets.hpp:46-59; complement map 1..9 -> 9..1: A<->t, C<->g,
# G<->c, T<->a, N<->N). Used to mask soft-masked (repeat) regions
# while keeping them in the graph.
DNA_CASE_SENT = Alphabet(
    name="DNACaseSent",
    letters="$ACGTNacgt",
    bits_per_char=4,
    complement=(0, 9, 8, 7, 6, 5, 4, 3, 2, 1),
    case_sensitive=True,
)

# Protein (reference kAlphabetProtein, 26 letters + sentinel → 8-bit fields).
PROTEIN = Alphabet(
    name="Protein",
    letters="$ABCDEFGHIJKLMNOPQRSTUVWYZX",
    bits_per_char=8,
)

ALPHABETS: Dict[str, Alphabet] = {
    a.name: a for a in (DNA, DNA5, DNA_CASE_SENT, PROTEIN)}
