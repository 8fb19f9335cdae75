"""Speculative-decoding drafters: prompt-lookup (n-gram) and CRDT-doc
(the port's own copy of ``repro.serving.draft``; host code, no tensors).

Both drafters are *model-free*: they propose k-token continuations by
matching the row's trailing n-gram against a token source and copying
whatever followed the most recent earlier occurrence.  The serving engine
then verifies the whole draft span in ONE ``lm.mixed_step`` call (decode
rows widen from span 1 to span 1+k) and commits the longest accepted
prefix plus the verifier's bonus token; rejected tails roll back bitwise
(`cache.snapshot_span` / `restore_span`), so speculative greedy output is
token-identical to non-speculative greedy output by construction.

Two token sources:

* :class:`NgramDrafter` — the row's own prompt + generated history
  ("prompt lookup").  Catches self-repetition: code generation re-emits
  identifiers, signatures, and boilerplate that already appeared
  upstream in the same context.
* :class:`DocDrafter` — the shared CRDT RGA document.  CodeCRDT agents
  regenerate text the document already converged on (re-contextualization
  literally replays committed code), so the *document* predicts a row's
  continuation even when the row's own history does not — e.g. an agent
  writing a call site for a function another agent already committed.
  Falls back to own-history lookup when the document has no match.

The drafters run on the host between steps; cost is O(len(source)) per
proposal at bench scales, far below one model step.
"""
from __future__ import annotations

from typing import Iterable, Optional, Sequence


def _lookup(source: Sequence[int], context: Sequence[int], k: int,
            max_ngram: int, min_ngram: int,
            exclude_final: bool = False) -> list[int]:
    """Continuation after the most recent match of context's trailing
    n-gram inside ``source`` (longest n first, rightmost occurrence).

    With ``exclude_final`` the match may not end at source's last token
    (used for self-lookup, where the trailing n-gram trivially matches
    itself and would propose nothing).
    """
    if k <= 0 or not source or not context:
        return []
    src = list(source)
    for n in range(min(max_ngram, len(context)), min_ngram - 1, -1):
        pat = list(context[-n:])
        hi = len(src) - n - (1 if exclude_final else 0)
        for i in range(hi, -1, -1):
            if src[i:i + n] == pat:
                cont = src[i + n:i + n + k]
                if cont:
                    return [int(t) for t in cont]
    return []


class NgramDrafter:
    """Prompt-lookup drafting from the row's own prompt+generated history."""

    name = "ngram"

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError("need 1 <= min_ngram <= max_ngram")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def propose(self, context: Sequence[int], k: int) -> list[int]:
        return _lookup(context, context, k, self.max_ngram, self.min_ngram,
                       exclude_final=True)


class DocDrafter:
    """Drafting from shared CRDT document content, own-history fallback.

    ``docs`` holds token sequences of converged document regions (e.g.
    the orchestrator's per-slot host mirrors); sequences may be live
    lists that grow as the document does.  Matches in later (more
    recently updated) docs win ties at equal n-gram length.
    """

    name = "doc"

    def __init__(self, max_ngram: int = 3, min_ngram: int = 2,
                 fallback: bool = True):
        self._docs: list[Sequence[int]] = []
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        self._fallback = (NgramDrafter(max_ngram=max_ngram)
                          if fallback else None)

    def set_docs(self, docs: Iterable[Sequence[int]]) -> None:
        self._docs = list(docs)

    def add_doc(self, doc: Sequence[int]) -> None:
        self._docs.append(doc)

    def propose(self, context: Sequence[int], k: int) -> list[int]:
        for n in range(self.max_ngram, self.min_ngram - 1, -1):
            for doc in reversed(self._docs):
                got = _lookup(doc, context, k, n, n)
                if got:
                    return got
        if self._fallback is not None:
            return self._fallback.propose(context, k)
        return []


def make_drafter(kind: str, **kw):
    """Factory for ``--spec-decode {ngram,doc}``."""
    if kind == "ngram":
        return NgramDrafter(**kw)
    if kind == "doc":
        return DocDrafter(**kw)
    raise ValueError(f"unknown drafter kind {kind!r} (want 'ngram' or 'doc')")


def accept_tokens(draft: Sequence[int], accepted: int, preds_row,
                  remaining: int, eos_id: Optional[int]) -> tuple[list[int], int]:
    """Host half of greedy longest-accepted-prefix acceptance.

    ``accepted`` is the device count from ``kernels.ref.speculative_accept``
    (how many draft tokens matched the verifier's argmax at their
    predecessor position); ``preds_row[j]`` is the argmax after span
    position j, so ``preds_row[accepted]`` is the *bonus* token — exactly
    the token non-speculative greedy decode would emit next, making every
    verify step commit >= 1 token.  The committed run is then truncated at
    the first eos (inclusive — matching the non-speculative stop rule) and
    capped at the row's remaining generation budget.

    Returns ``(appended, accepted)`` — the tokens to commit, and the
    device accept count clamped to the draft length (callers count
    ``min(len(appended), accepted)`` draft tokens as accepted).
    """
    a = min(int(accepted), len(draft))
    appended = [int(t) for t in draft[:a]] + [int(preds_row[a])]
    if eos_id is not None and eos_id in appended:
        appended = appended[:appended.index(eos_id) + 1]
    return appended[:max(1, int(remaining))], a
