"""Evaluator agent: semantic-conflict detection and automatic reconciliation
(paper §4.3).

CRDTs guarantee character-level convergence but cannot see semantics.  The
evaluator scans the converged document for duplicate symbol declarations
(the paper's dominant conflict class) and reconciles them the way its
auto-fix does: the later declaration is renamed to a fresh symbol.  The fix
is an ordinary CRDT edit (append-only patch records), so it merges and
converges like any agent edit.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import doc as doc_mod

DECL_MOD = 13
DECL_RESIDUE = 5
SYMBOL_SPACE = 64


@dataclass
class Conflict:
    symbol: int
    first_slot: int
    dup_slot: int
    dup_index: int          # position within the dup slot


@dataclass
class Report:
    conflicts: list[Conflict] = field(default_factory=list)
    total_declarations: int = 0
    fixed: int = 0
    flagged: list[Conflict] = field(default_factory=list)

    @property
    def conflict_rate_per_1k(self) -> float:
        total_tokens = max(self.total_tokens, 1)
        return 1000.0 * len(self.conflicts) / total_tokens

    total_tokens: int = 0


def _host(merged: doc_mod.SlotDoc) -> tuple[np.ndarray, np.ndarray]:
    return merged.length.cpu().numpy(), merged.tokens.cpu().numpy()


def scan(merged: doc_mod.SlotDoc) -> Report:
    """Find duplicate declarations across slots (deterministic order)."""
    lengths, tokens = _host(merged)
    declared: dict[int, int] = {}
    rep = Report(total_tokens=int(lengths.sum()))
    for s in range(merged.num_slots):
        for i in range(int(lengths[s])):
            t = int(tokens[s, i])
            if t % DECL_MOD == DECL_RESIDUE:
                rep.total_declarations += 1
                sym = t % SYMBOL_SPACE
                if sym in declared and declared[sym] != s:
                    rep.conflicts.append(
                        Conflict(symbol=sym, first_slot=declared[sym],
                                 dup_slot=s, dup_index=i))
                else:
                    declared.setdefault(sym, s)
    return rep


def _fresh_symbol_token(used: set[int]) -> int | None:
    """A declaration-class token whose symbol is unused (tok ≡ 5 mod 13)."""
    for sym in range(SYMBOL_SPACE):
        if sym in used:
            continue
        for tok in range(DECL_RESIDUE, 13 * 64, DECL_MOD):
            if tok % SYMBOL_SPACE == sym:
                return tok
    return None


def reconcile(merged: doc_mod.SlotDoc, patch_slot: int | None = None
              ) -> tuple[doc_mod.SlotDoc, Report]:
    """Auto-fix duplicate declarations by appending rename patches.

    Appends, per fixable conflict, a 3-token patch record (old declaration
    token, dup slot id, fresh declaration token) to the patch slot.
    Conflicts with no fresh symbol available are flagged for review."""
    rep = scan(merged)
    if patch_slot is None:
        patch_slot = merged.num_slots - 1
    used = {c.symbol for c in rep.conflicts}
    lengths, tokens = _host(merged)
    for s in range(merged.num_slots):
        for i in range(int(lengths[s])):
            t = int(tokens[s, i])
            if t % DECL_MOD == DECL_RESIDUE:
                used.add(t % SYMBOL_SPACE)

    doc = merged
    for c in rep.conflicts:
        fresh = _fresh_symbol_token(used)
        if fresh is None:
            rep.flagged.append(c)
            continue
        used.add(fresh % SYMBOL_SPACE)
        old_tok = int(tokens[c.dup_slot, c.dup_index])
        patch = torch.tensor([old_tok, c.dup_slot, fresh, 0],
                             dtype=torch.int32, device=doc.tokens.device)
        doc = doc_mod.append(doc, patch_slot, patch, 3)
        rep.fixed += 1
    return doc, rep


def score(merged: doc_mod.SlotDoc, rep: Report | None = None
          ) -> dict[str, float]:
    """Objective 0-20 scores over measurable quantities (the objective half
    of paper §5.2.3)."""
    rep = rep or scan(merged)
    tokens = max(rep.total_tokens, 1)
    quality = max(0.0, 20.0 - 40.0 * len(rep.conflicts) / tokens * 10)
    functionality = 20.0 * min(1.0, rep.total_declarations / 8)
    return {
        "code_quality": round(quality, 2),
        "functionality": round(functionality, 2),
        "conflicts_per_1k": round(1000.0 * len(rep.conflicts) / tokens, 3),
    }
