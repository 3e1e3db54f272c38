"""Symbol inventory for text input.

Must match the reference vocabulary exactly — 148 symbols in the same order
(reference text/symbols.py:9-18) — because embedding rows are indexed by
symbol ID and checkpoints are transferable only if the order is preserved:
pad '_', special '-', punctuation, ASCII letters, then '@'-prefixed ARPAbet.
"""

# The 84 ARPAbet phone symbols accepted by CMUdict (with 0/1/2 stress marks on
# vowels). Order matters: IDs 64..147 of the embedding table.
ARPABET = [
    "AA", "AA0", "AA1", "AA2", "AE", "AE0", "AE1", "AE2",
    "AH", "AH0", "AH1", "AH2", "AO", "AO0", "AO1", "AO2",
    "AW", "AW0", "AW1", "AW2", "AY", "AY0", "AY1", "AY2",
    "B", "CH", "D", "DH",
    "EH", "EH0", "EH1", "EH2", "ER", "ER0", "ER1", "ER2",
    "EY", "EY0", "EY1", "EY2",
    "F", "G", "HH",
    "IH", "IH0", "IH1", "IH2", "IY", "IY0", "IY1", "IY2",
    "JH", "K", "L", "M", "N", "NG",
    "OW", "OW0", "OW1", "OW2", "OY", "OY0", "OY1", "OY2",
    "P", "R", "S", "SH", "T", "TH",
    "UH", "UH0", "UH1", "UH2", "UW", "UW0", "UW1", "UW2",
    "V", "W", "Y", "Z", "ZH",
]

PAD = "_"

_PUNCTUATION = "!'(),.:;? "
_LETTERS = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"

SYMBOLS = (
    [PAD]
    + ["-"]
    + list(_PUNCTUATION)
    + list(_LETTERS)
    + ["@" + phone for phone in ARPABET]
)

SYMBOL_TO_ID = {s: i for i, s in enumerate(SYMBOLS)}
ID_TO_SYMBOL = {i: s for i, s in enumerate(SYMBOLS)}

N_SYMBOLS = len(SYMBOLS)  # 148
