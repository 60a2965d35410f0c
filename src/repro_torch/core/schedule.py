"""Per-leaf DMD scheduling: group rules -> per-group windows (DESIGN.md §4).

A copy of the reference's host-side schedule arithmetic (it is pure Python
there too). With ``cycle = cooldown + m`` and ``eff = step - warmup - phase``:

    slot(step) = -1                          if eff < 0   (not started)
                 eff % cycle - cooldown      otherwise    (< 0 in cooldown)

a snapshot is recorded when slot >= 0, and the group jumps when
slot == m - 1. Group 0 is always the default group built from the
DMDConfig globals; further groups come from ``cfg.groups`` rules, first
match wins.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class DMDGroupRule:
    """One config-declared scheduling rule: matcher + overrides.

    The matcher (path regex on the normalised path, bounds on the raw ndim
    and element count; -1 = unbounded) selects leaves; ``exclude=True``
    removes them from DMD, otherwise the rule defines a schedule group whose
    ``None`` fields inherit the DMDConfig globals."""
    name: str = ""
    path_regex: str = ""
    min_ndim: int = 0
    max_ndim: int = -1
    min_size: int = 0
    max_size: int = -1
    exclude: bool = False
    m: Optional[int] = None
    s: Optional[int] = None
    warmup_steps: Optional[int] = None
    cooldown_steps: Optional[int] = None
    phase: int = 0
    relax: Optional[float] = None
    anneal: Optional[float] = None
    reset_opt: Optional[bool] = None
    energy: Optional[float] = None
    ridge: Optional[float] = None

    def matches(self, path: str, ndim: int, size: int) -> bool:
        if self.path_regex and not re.search(self.path_regex, path):
            return False
        if ndim < self.min_ndim:
            return False
        if 0 <= self.max_ndim < ndim:
            return False
        if size < self.min_size:
            return False
        if 0 <= self.max_size < size:
            return False
        return True


@dataclass(frozen=True)
class GroupSchedule:
    """One resolved schedule group."""
    index: int
    name: str
    m: int
    s: int
    warmup_steps: int
    cooldown_steps: int
    phase: int
    relax: float
    anneal: float
    reset_opt: bool = True
    energy: float = 0.0
    ridge: float = 0.0

    @property
    def cycle(self) -> int:
        return self.cooldown_steps + self.m

    def slot(self, step: int) -> int:
        """Buffer row for the snapshot taken after optimizer step `step`;
        negative while not recording (warmup / phase / cooldown)."""
        eff = int(step) - self.warmup_steps - self.phase
        if eff < 0:
            return -1
        return eff % self.cycle - self.cooldown_steps

    def should_record(self, step: int) -> bool:
        return self.slot(step) >= 0

    def should_apply(self, step: int) -> bool:
        return self.slot(step) == self.m - 1

    def round_index(self, step: int) -> int:
        return (int(step) - self.warmup_steps - self.phase) // self.cycle

    def relax_for_round(self, round_idx: int) -> float:
        return float(self.relax * (self.anneal ** max(round_idx, 0)))


def rules_for_config(cfg) -> Tuple[DMDGroupRule, ...]:
    """The legacy ``param_filter`` / ``min_param_size`` strings mapped onto
    exclusion rules (resolved first), then ``cfg.groups`` in order."""
    legacy = []
    if cfg.param_filter == "non_expert":
        legacy.append(DMDGroupRule(name="legacy_non_expert",
                                   path_regex="expert", exclude=True))
    elif cfg.param_filter == "matrices_only":
        legacy.append(DMDGroupRule(name="legacy_matrices_only",
                                   max_ndim=1, exclude=True))
    elif cfg.param_filter != "all":
        raise ValueError(f"unknown param_filter {cfg.param_filter!r}")
    if cfg.min_param_size > 1:
        legacy.append(DMDGroupRule(name="legacy_min_param_size",
                                   max_size=cfg.min_param_size - 1,
                                   exclude=True))
    return tuple(legacy) + tuple(cfg.groups or ())


def _validate(g: GroupSchedule) -> GroupSchedule:
    if g.m < 3:
        raise ValueError(f"group {g.name!r}: DMD needs m >= 3 (got {g.m})")
    for name in ("warmup_steps", "cooldown_steps", "phase"):
        if getattr(g, name) < 0:
            raise ValueError(f"group {g.name!r}: {name} must be >= 0")
    if g.s < 1:
        raise ValueError(f"group {g.name!r}: s must be >= 1 (got {g.s})")
    if not 0.0 <= g.energy <= 1.0:
        raise ValueError(
            f"group {g.name!r}: energy must be in [0, 1] (got {g.energy})")
    if not (g.ridge >= 0.0 and math.isfinite(g.ridge)):
        raise ValueError(
            f"group {g.name!r}: ridge must be finite and >= 0 "
            f"(got {g.ridge})")
    return g


def resolve_groups(cfg) -> Tuple[GroupSchedule, ...]:
    """Config -> the resolved group table. Group 0 is the DMDConfig
    globals (phase 0); groups 1..K are the non-exclude rules in order. The
    energy and ridge targets stay 0.0 unless the controller is enabled."""
    reset_default = bool(cfg.reset_opt_state)
    ccfg = cfg.controller
    ctrl_on = ccfg is not None and ccfg.enabled
    energy_default = float(ccfg.energy) if ctrl_on else 0.0
    ridge_default = float(ccfg.ridge) if ctrl_on else 0.0
    groups = [_validate(GroupSchedule(
        index=0, name="default", m=cfg.m, s=cfg.s,
        warmup_steps=cfg.warmup_steps, cooldown_steps=cfg.cooldown_steps,
        phase=0, relax=cfg.relax, anneal=cfg.anneal,
        reset_opt=reset_default, energy=energy_default,
        ridge=ridge_default))]

    def pick(v, d):
        return d if v is None else v

    for rule in rules_for_config(cfg):
        if rule.exclude:
            continue
        idx = len(groups)
        groups.append(_validate(GroupSchedule(
            index=idx, name=rule.name or f"group{idx}",
            m=pick(rule.m, cfg.m), s=pick(rule.s, cfg.s),
            warmup_steps=pick(rule.warmup_steps, cfg.warmup_steps),
            cooldown_steps=pick(rule.cooldown_steps, cfg.cooldown_steps),
            phase=rule.phase,
            relax=pick(rule.relax, cfg.relax),
            anneal=pick(rule.anneal, cfg.anneal),
            reset_opt=pick(rule.reset_opt, reset_default),
            energy=(pick(rule.energy, energy_default) if ctrl_on else 0.0),
            ridge=(pick(rule.ridge, ridge_default) if ctrl_on else 0.0))))
    return tuple(groups)


def group_for_leaf(cfg, path: str, ndim: int, size: int) -> Optional[int]:
    """Index into ``resolve_groups(cfg)`` for one leaf, or None when it is
    excluded. First matching rule wins; no match -> the default group 0.
    Zero-size leaves are never schedulable."""
    if size < 1:
        return None
    next_group = 1
    for rule in rules_for_config(cfg):
        gi = None if rule.exclude else next_group
        if not rule.exclude:
            next_group += 1
        if rule.matches(path, ndim, size):
            return gi
    return 0


def slots_array(groups: Sequence[GroupSchedule], step: int) -> np.ndarray:
    """Per-group slot vector (concrete ints)."""
    return np.asarray([g.slot(step) for g in groups], np.int32)
