"""The six benchmark tasks (paper §5.2.1), as coupling-structured TODO DAGs
(the port's own copy of ``repro.agents.tasks``).

Coupling is operationalized exactly as the paper defines it: the fraction of
TODOs whose implementation requires *reading* shared state produced by other
TODOs.  ``deps`` are hard ordering edges (ready-gating); ``reads`` are soft
context edges — if a read slot's content changes while an agent is
generating, the agent must re-contextualize (the observation-driven
invalidation that produces the paper's coupled-task slowdown).

``par_inflation`` injects the paper's *measured* code-volume ratios
(Table 5: parallel/sequential code length) as a workload input: volume
inflation is an LLM behavior we cannot re-derive from a toy model, but its
*systems* consequences (raw-vs-normalized time inversion) are what we
reproduce and measure.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class TaskSpec:
    name: str
    coupling: str                      # low | medium | high
    n_todos: int
    deps: dict[int, tuple[int, ...]]   # hard ordering edges
    reads: dict[int, tuple[int, ...]]  # soft context edges (invalidation)
    base_tokens: int                   # generated tokens per TODO (sequential)
    par_inflation: float               # paper Table 5 par/seq code-length ratio
    prompt_tokens: int                 # context replay length per TODO
    read_prompt_tokens: int            # extra prompt per read edge


def _all_prior_reads(n, frac):
    """Each TODO reads ~frac of the other TODOs (shared-state coupling)."""
    reads = {}
    step = max(1, int(round(1 / max(frac, 1e-6))))
    for k in range(n):
        reads[k] = tuple(j for j in range(n) if j != k and (j + k) % step == 0)
    return reads


TASKS: dict[str, TaskSpec] = {
    # Low coupling (<30%): independent cell logic / field validators.
    "tic_tac_toe": TaskSpec(
        name="tic_tac_toe", coupling="low", n_todos=8,
        deps={}, reads=_all_prior_reads(8, 0.15),
        base_tokens=56, par_inflation=0.89, prompt_tokens=24,
        read_prompt_tokens=8),
    "registration": TaskSpec(
        name="registration", coupling="low", n_todos=8,
        deps={7: (0,)}, reads=_all_prior_reads(8, 0.20),
        base_tokens=72, par_inflation=1.10, prompt_tokens=28,
        read_prompt_tokens=8),
    # Medium coupling: partially independent formatting functions.
    "markdown": TaskSpec(
        name="markdown", coupling="medium", n_todos=8,
        deps={6: (0,), 7: (1,)}, reads=_all_prior_reads(8, 0.45),
        base_tokens=80, par_inflation=0.88, prompt_tokens=32,
        read_prompt_tokens=12),
    # High coupling (>50%): most TODOs depend on shared state established by
    # other TODOs (the paper's operationalization), which serializes claims.
    "pomodoro": TaskSpec(
        name="pomodoro", coupling="high", n_todos=8,
        # 0 = timer core; logic 1-5 builds on it; UI 6-7 on the logic.
        deps={1: (0,), 2: (0,), 3: (0,), 4: (0,), 5: (0,),
              6: (4, 5), 7: (6,)},
        reads=_all_prior_reads(8, 0.60),
        base_tokens=64, par_inflation=1.82, prompt_tokens=32,
        read_prompt_tokens=16),
    "dashboard": TaskSpec(
        name="dashboard", coupling="high", n_todos=8,
        # 0 = shared data context; widgets hang off it; layout last.
        deps={1: (0,), 2: (0,), 3: (0,), 4: (0,), 5: (1, 2),
              6: (3, 4), 7: (5, 6)},
        reads=_all_prior_reads(8, 0.65),
        base_tokens=72, par_inflation=1.98, prompt_tokens=36,
        read_prompt_tokens=16),
    "visualizer": TaskSpec(
        name="visualizer", coupling="high", n_todos=8,
        # 0 = coordinated animation state; steps 1-4 animate; 5-7 render.
        deps={1: (0,), 2: (0,), 3: (0,), 4: (0,),
              5: (1, 2), 6: (2, 3), 7: (5, 6)},
        reads=_all_prior_reads(8, 0.70),
        base_tokens=80, par_inflation=2.89, prompt_tokens=36,
        read_prompt_tokens=16),
}

LOW = ("tic_tac_toe", "registration")
MEDIUM = ("markdown",)
HIGH = ("pomodoro", "dashboard", "visualizer")
