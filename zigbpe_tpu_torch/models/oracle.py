"""Pure-Python conformance oracle for byte-level BPE.

This module is the *semantic contract*: a deliberately simple, loop-based
implementation of the reference tokenizer's observable behavior
(reference: zig-bpe src/basic_tokenizer.zig). The PyTorch/CUDA device
implementations are tested against this oracle, and the oracle itself is
tested against the reference's committed golden artifact ``merges.txt``.

Semantics pinned here (reference file:line cites):

* Byte-level initial tokenization: one token per raw byte, ids 0..255
  (basic_tokenizer.zig:155-170).
* Pair counting: every adjacent pair, overlaps included
  (basic_tokenizer.zig:234-278) — ``aaa`` counts ``(a,a)`` twice.
* Selection: strict argmax by count (basic_tokenizer.zig:280-306). The
  reference's tie-break is hashmap iteration order; we adopt the documented
  deterministic rule *largest (first, second) wins*, which reproduces the
  single tie in the golden run (merge #39, pair (265,101) over (46,10)).
* Merge application: leftmost-greedy single pass, newly written tokens are
  not re-matched within the pass (basic_tokenizer.zig:207-232):
  ``aaa`` + (a,a)->X  =>  [X, a].
* Encode: replay merges strictly in training order, one greedy pass per
  merge (basic_tokenizer.zig:71-88).
* Decode: recursive expansion through the merge table; unknown id >= 256
  raises (basic_tokenizer.zig:90-138).
* train rejects vocab_size < 256 (basic_tokenizer.zig:147-149); stops early
  when fewer than two tokens remain (basic_tokenizer.zig:188-191).
"""

from __future__ import annotations

from collections import Counter
from typing import List, Sequence, Tuple

VOCAB_START = 256

Merge = Tuple[int, int, int]  # (first, second, new_token)


class InvalidVocabSizeError(ValueError):
    pass


class InvalidTokenError(ValueError):
    pass


def initial_tokens(text: bytes | str) -> List[int]:
    """Byte-level initial tokenization (basic_tokenizer.zig:155-170)."""
    if isinstance(text, str):
        text = text.encode("utf-8")
    return list(text)


def merge_pass(tokens: Sequence[int], first: int, second: int, new_token: int) -> List[int]:
    """One leftmost-greedy merge pass (basic_tokenizer.zig:207-232).

    Newly written tokens are never re-matched within the same pass.
    """
    out: List[int] = []
    i = 0
    n = len(tokens)
    while i < n:
        if i + 1 < n and tokens[i] == first and tokens[i + 1] == second:
            out.append(new_token)
            i += 2
        else:
            out.append(tokens[i])
            i += 1
    return out


def count_pairs(tokens: Sequence[int]) -> Counter:
    """Histogram of all adjacent pairs, overlaps included
    (basic_tokenizer.zig:234-278)."""
    return Counter(zip(tokens, tokens[1:]))


def select_top_pair(counts: Counter) -> Tuple[Tuple[int, int], int]:
    """Argmax by count; ties resolved to the largest (first, second)
    (documented deterministic tie-break; see module docstring)."""
    pair, n = max(counts.items(), key=lambda kv: (kv[1], kv[0]))
    return pair, n


def train(
    text: bytes | str,
    vocab_size: int,
    verbose: bool = False,
) -> List[Merge]:
    """Train a BPE merge table (basic_tokenizer.zig:140-205).

    Returns the ordered merge list — order *is* the model.
    """
    if vocab_size < VOCAB_START:
        raise InvalidVocabSizeError(f"vocab_size must be >= 256, got {vocab_size}")
    tokens = initial_tokens(text)
    merges: List[Merge] = []
    for new_token in range(VOCAB_START, vocab_size):
        counts = count_pairs(tokens)
        if not counts:
            # fewer than 2 tokens remain (basic_tokenizer.zig:188-191)
            break
        (first, second), n = select_top_pair(counts)
        if verbose:
            print(
                f"merge {new_token - VOCAB_START + 1}/{vocab_size - VOCAB_START}: "
                f"({first},{second}) -> {new_token} had {n} occurrences"
            )
        merges.append((first, second, new_token))
        tokens = merge_pass(tokens, first, second, new_token)
    return merges


def encode(text: bytes | str, merges: Sequence[Merge]) -> List[int]:
    """Encode by replaying merges in training order
    (basic_tokenizer.zig:71-88)."""
    tokens = initial_tokens(text)
    for first, second, new_token in merges:
        tokens = merge_pass(tokens, first, second, new_token)
    return tokens


def decode(token_ids: Sequence[int], merges: Sequence[Merge]) -> bytes:
    """Decode via recursive merge expansion (basic_tokenizer.zig:90-138)."""
    table = {new_token: (first, second) for first, second, new_token in merges}
    out = bytearray()

    def expand(tok: int) -> None:
        if 0 <= tok < VOCAB_START:
            out.append(tok)
            return
        if tok not in table:
            # the reference errors on any id outside the vocab
            # (basic_tokenizer.zig:101 error.InvalidToken)
            raise InvalidTokenError(f"unknown token id {tok}")
        a, b = table[tok]
        expand(a)
        expand(b)

    for tok in token_ids:
        expand(tok)
    return bytes(out)
