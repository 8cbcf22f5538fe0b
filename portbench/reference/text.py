"""The text frontend of the plain reference: normalisation, G2P and
phoneme-id encoding, frozen here so the reference computes the ids the
program must feed its embedding table without reading the program.

The inventory, lexicon, cleaners and letter-to-sound rules are the data
contract of the m2-tts reference (src/utils/text.py). ``TextProcessor``
keeps its quirk: ``length`` counts the non-SIL phonemes, so the padding
mask leaves out the two boundary SIL tokens' worth of positions at the end.
"""

from __future__ import annotations

import re
import string
import unicodedata
from typing import Dict, List, Optional

import numpy as np

# ---------------------------------------------------------------------------
# Phoneme inventory (ARPAbet subset + specials). Order defines integer ids.
# Must match reference src/utils/text.py:14-23.
# ---------------------------------------------------------------------------
_VOWELS = "AA AE AH AO AW AY EH ER EY IH IY OW OY UH UW"
_CONSONANTS = "B CH D DH F G HH JH K L M N NG P R S SH T TH V W Y Z ZH"
_SPECIALS = "SIL SP UNK"  # silence, short pause, unknown

PHONEMES: List[str] = (_VOWELS + " " + _CONSONANTS + " " + _SPECIALS).split()
PHONEME_TO_ID: Dict[str, int] = {p: i for i, p in enumerate(PHONEMES)}
ID_TO_PHONEME: Dict[int, str] = dict(enumerate(PHONEMES))

SIL_ID = PHONEME_TO_ID["SIL"]
SP_ID = PHONEME_TO_ID["SP"]
UNK_ID = PHONEME_TO_ID["UNK"]

VOCAB_SIZE_DEFAULT = 256  # embedding-table size used by the models


# ---------------------------------------------------------------------------
# Text cleaners. Behavior matches reference src/utils/text.py:30-101
# (substring abbreviation expansion in fixed order; 0-20 number words with
# punctuation preserved; lowercase + NFD + whitespace collapse).
# ---------------------------------------------------------------------------

# Ordered: plain substring replacement is applied in this sequence.
_ABBREVIATIONS = (
    ("dr.", "doctor"),
    ("mr.", "mister"),
    ("mrs.", "missus"),
    ("ms.", "miss"),
    ("st.", "saint"),
    ("etc.", "et cetera"),
    ("vs.", "versus"),
    ("e.g.", "for example"),
    ("i.e.", "that is"),
    ("&", "and"),
)

_NUMBER_WORDS = {
    str(n): w
    for n, w in enumerate(
        "zero one two three four five six seven eight nine ten eleven twelve "
        "thirteen fourteen fifteen sixteen seventeen eighteen nineteen twenty".split()
    )
}

_WHITESPACE_RE = re.compile(r"\s+")


def expand_abbreviations(text: str) -> str:
    text = text.lower()
    for abbrev, expansion in _ABBREVIATIONS:
        text = text.replace(abbrev, expansion)
    return text


def expand_numbers(text: str) -> str:
    out = []
    for word in text.split():
        core = word.strip(string.punctuation)
        if core.isdigit() and core in _NUMBER_WORDS:
            n_lead = len(word) - len(word.lstrip(string.punctuation))
            n_keep = len(word.rstrip(string.punctuation))
            out.append(word[:n_lead] + _NUMBER_WORDS[core] + word[n_keep:])
        else:
            out.append(word)
    return " ".join(out)


def normalize_text(text: str) -> str:
    text = text.lower()
    text = unicodedata.normalize("NFD", text)
    text = expand_abbreviations(text)
    text = expand_numbers(text)
    return _WHITESPACE_RE.sub(" ", text.strip())


# ---------------------------------------------------------------------------
# Lexicon: ~90 common words. Pronunciations are the reference's data
# contract (reference src/utils/text.py:119-212).
# ---------------------------------------------------------------------------
_LEXICON_SRC = """
hello HH EH L OW      | world W ER L D       | the DH AH          | and AE N D
to T UW               | a AH                 | of AH V            | in IH N
is IH Z               | it IH T              | you Y UW           | that DH AE T
he HH IY              | was W AH Z           | for F ER           | on AO N
are AA R              | as AE Z              | with W IH TH       | his HH IH Z
they DH EY            | i AY                 | at AE T            | be B IY
this DH IH S          | have HH AE V         | from F R AH M      | or ER
one W AH N            | had HH AE D          | by B AY            | word W ER D
but B AH T            | not N AA T           | what W AH T        | all AO L
were W ER             | we W IY              | when W EH N        | your Y ER
can K AE N            | said S EH D          | there DH EH R      | each IY CH
which W IH CH         | do D UW              | how HH AW          | their DH EH R
if IH F               | will W IH L          | up AH P            | other AH DH ER
about AH B AW T       | out AW T             | many M EH N IY     | then DH EH N
them DH EH M          | these DH IY Z        | so S OW            | some S AH M
her HH ER             | would W UH D         | make M EY K        | like L AY K
into IH N T UW        | him HH IH M          | time T AY M        | two T UW
more M ER             | go G OW              | no N OW            | way W EY
could K UH D          | my M AY              | than DH AE N       | first F ER S T
been B IH N           | call K AO L          | who HH UW          | its IH T S
now N AW              | find F AY N D        | long L AO NG       | down D AW N
day D EY              | did D IH D           | get G EH T         | come K AH M
made M EY D           | may M EY             | part P AA R T
"""


def _parse_lexicon(src: str) -> Dict[str, List[str]]:
    lex: Dict[str, List[str]] = {}
    for entry in src.replace("\n", "|").split("|"):
        tokens = entry.split()
        if tokens:
            lex[tokens[0]] = tokens[1:]
    return lex


LEXICON: Dict[str, List[str]] = _parse_lexicon(_LEXICON_SRC)

# Letter-to-sound fallback tables (reference src/utils/text.py:224-233).
_LTS_CONSONANTS = {
    "b": "B", "c": "K", "d": "D", "f": "F", "g": "G", "h": "HH",
    "j": "JH", "k": "K", "l": "L", "m": "M", "n": "N", "p": "P",
    "q": "K", "r": "R", "s": "S", "t": "T", "v": "V", "w": "W",
    "x": "K", "y": "Y", "z": "Z",
}
_LTS_VOWELS = {"a": "AE", "e": "EH", "i": "IH", "o": "AO", "u": "UH"}


def letter_to_sound(word: str) -> List[str]:
    """Per-letter fallback for out-of-lexicon words; unknown chars dropped."""
    phones = []
    for ch in word.lower():
        if ch in _LTS_CONSONANTS:
            phones.append(_LTS_CONSONANTS[ch])
        elif ch in _LTS_VOWELS:
            phones.append(_LTS_VOWELS[ch])
    return phones or ["UNK"]


class SimpleG2P:
    """Lexicon + letter-to-sound grapheme-to-phoneme converter.

    Inserts `SP` between words and wraps the utterance in `SIL` tokens,
    matching reference src/utils/text.py:245-282.
    """

    def __init__(self, extra_lexicon: Optional[Dict[str, List[str]]] = None):
        self.lexicon = dict(LEXICON)
        if extra_lexicon:
            self.lexicon.update(extra_lexicon)

    def _convert(self, text: str) -> tuple:
        words = normalize_text(text).split()
        phones: List[str] = []
        for word in words:
            core = word.strip(string.punctuation)
            phones.extend(self.lexicon.get(core) or letter_to_sound(core))
            phones.append("SP")
        if phones and phones[-1] == "SP":
            phones.pop()
        return tuple(["SIL"] + phones + ["SIL"])

    def convert(self, text: str) -> List[str]:
        return list(self._convert(text))


class TextProcessor:
    """Text → phoneme ids with fixed-shape padding for compiled graphs.

    `process(text, max_length)` pads/truncates to `max_length` with SIL and
    reports `length` as the number of non-SIL phonemes (matching the
    reference's convention, src/utils/text.py:346 — note this also excludes
    the two boundary SIL tokens, a quirk kept for parity since it feeds the
    attention padding mask).
    """

    def __init__(self, vocab_size: int = VOCAB_SIZE_DEFAULT,
                 extra_lexicon: Optional[Dict[str, List[str]]] = None):
        self.vocab_size = vocab_size
        self.g2p = SimpleG2P(extra_lexicon)

    def text_to_phonemes(self, text: str) -> List[str]:
        return self.g2p.convert(text)

    def phonemes_to_ids(self, phonemes: List[str]) -> List[int]:
        return [PHONEME_TO_ID.get(p, UNK_ID) for p in phonemes]

    def ids_to_phonemes(self, ids) -> List[str]:
        return [ID_TO_PHONEME.get(int(i), "UNK") for i in ids]

    def process(self, text: str, max_length: Optional[int] = None) -> Dict:
        phonemes = self.text_to_phonemes(text)
        ids = self.phonemes_to_ids(phonemes)
        if max_length is not None:
            if len(ids) > max_length:
                ids = ids[:max_length]
                phonemes = phonemes[:max_length]
            else:
                pad = max_length - len(ids)
                ids = ids + [SIL_ID] * pad
                phonemes = phonemes + ["SIL"] * pad
        return {
            "text": text,
            "phonemes": phonemes,
            "phoneme_ids": np.asarray(ids, dtype=np.int32),
            "length": sum(1 for p in phonemes if p != "SIL"),
        }

    def batch(self, texts: List[str], max_length: int) -> Dict[str, np.ndarray]:
        """Encode a list of texts into one fixed-shape [B, max_length] batch."""
        outs = [self.process(t, max_length) for t in texts]
        return {
            "phoneme_ids": np.stack([o["phoneme_ids"] for o in outs]),
            "lengths": np.asarray([o["length"] for o in outs], dtype=np.int32),
        }
