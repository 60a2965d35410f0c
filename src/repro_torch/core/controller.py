"""Loss-gated adaptive jump controller (DESIGN.md §5).

A copy of the reference's controller math in torch. At a group's jump step
the DMD step (``train/step.py::make_dmd_step``) scores the pre-jump and the
jumped params on a held-out validation batch:

  * ACCEPT  (loss_post <= loss_pre * (1 + accept_tol), finite): keep it.
  * SCALED  : the first ``shrink_levels`` blend
    ``level * w_jump + (1 - level) * w_pre`` the gate accepts (relax enters
    the coefficients linearly, so a blend IS the level-scaled jump).
  * REJECT  : bit-exact rollback to the pre-jump params and moments.

Per-group counters, a full-accept streak and a gain EMA drive the adapted
horizon ``s_eff`` (grown on consecutive accepts, shrunk on rejects, inside
``schedule.s_bounds``) and the relax scale ``relax_eff``. With
``meta_lr > 0`` the gate loss is backpropagated through the jump into
per-group relax and ridge knobs, and ``meta_update`` moves ``relax_eff``
and ``ridge_eff`` one EMA step toward the boundary the gradient's sign
points at.

``ControllerState`` is a NamedTuple of ``(n_groups,)`` tensors on the
training device, carried in ``TrainState``.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from repro_torch.core import schedule as sched_mod

# Gate outcomes
REJECT, SCALED, ACCEPT = 0, 1, 2


class ControllerState(NamedTuple):
    """Per-group controller state, all (n_groups,) tensors."""
    accepts: torch.Tensor     # int32: jumps kept at full strength
    scaled: torch.Tensor      # int32: jumps kept after a relax scale-back
    rejects: torch.Tensor     # int32: jumps rolled back
    streak: torch.Tensor      # int32: consecutive FULL accepts
    gain_ema: torch.Tensor    # fp32: EMA of (loss_pre - loss_final)/loss_pre
    s_eff: torch.Tensor       # fp32: adapted horizon (<= configured s)
    relax_eff: torch.Tensor   # fp32: effective relax scale in (0, 1]
    ridge_eff: torch.Tensor   # fp32: meta-tuned ridge in [0, ridge_max]


def init_state(groups: Sequence[sched_mod.GroupSchedule], device="cpu"
               ) -> ControllerState:
    """Fresh state on `device`: zero counters, s_eff at each group's
    configured cap, relax scale 1, ridge at each group's schedule ridge."""
    n = len(groups)

    def zi():
        return torch.zeros((n,), dtype=torch.int32, device=device)
    return ControllerState(
        accepts=zi(), scaled=zi(), rejects=zi(), streak=zi(),
        gain_ema=torch.zeros((n,), dtype=torch.float32, device=device),
        s_eff=torch.as_tensor(sched_mod.s_caps(groups), device=device),
        relax_eff=torch.ones((n,), dtype=torch.float32, device=device),
        ridge_eff=torch.tensor([float(getattr(g, "ridge", 0.0))
                                for g in groups], dtype=torch.float32,
                               device=device))


def effective_s(state: ControllerState,
                groups: Sequence[sched_mod.GroupSchedule],
                ccfg) -> torch.Tensor:
    """(n_groups,) int32 horizons for this jump."""
    return sched_mod.effective_s_vector(groups, state.s_eff,
                                        s_floor=ccfg.s_min)


def gate_outcome(loss_pre, loss_candidate, accept_tol: float
                 ) -> torch.Tensor:
    """The accept predicate: finite AND within (1 + accept_tol) of the
    pre-jump held-out loss (a bool tensor)."""
    thresh = loss_pre * (1.0 + accept_tol)
    return torch.isfinite(loss_candidate) & (loss_candidate <= thresh)


def _group_mask(jumped: Tuple[int, ...], n: int, device) -> torch.Tensor:
    mask = torch.zeros((n,), dtype=torch.bool)
    mask[list(jumped)] = True
    return mask.to(device)


def update_on_jump(state: ControllerState, jumped: Tuple[int, ...],
                   outcome, gain, ccfg,
                   groups: Sequence[sched_mod.GroupSchedule],
                   level=0.5) -> ControllerState:
    """Fold one gate decision into the per-group state. `jumped` are the
    groups whose window closed (they share the decision), `outcome` the
    REJECT/SCALED/ACCEPT code (int or tensor), `gain` the relative
    improvement of the kept params on the gate batch, `level` the blend
    fraction a SCALED outcome kept. Other groups pass through."""
    dev = state.s_eff.device
    gmask = _group_mask(jumped, len(groups), dev)
    outcome = torch.as_tensor(outcome, device=dev)
    full = outcome == ACCEPT
    half = outcome == SCALED
    rej = outcome == REJECT

    accepts = state.accepts + (gmask & full).to(torch.int32)
    scaled = state.scaled + (gmask & half).to(torch.int32)
    rejects = state.rejects + (gmask & rej).to(torch.int32)
    streak = torch.where(gmask, torch.where(full, state.streak + 1,
                                            torch.zeros_like(state.streak)),
                         state.streak)

    # the same [floor, cap] band the realized horizon is clamped into
    lo, caps = sched_mod.s_bounds(groups, s_floor=ccfg.s_min, device=dev)
    s_grown = torch.minimum(state.s_eff * ccfg.grow, caps)
    s_shrunk = torch.maximum(state.s_eff * ccfg.shrink, lo)
    # grow only on CONSECUTIVE accepts, shrink on every reject
    s_eff = torch.where(gmask & rej, s_shrunk,
                        torch.where(gmask & full & (streak >= 2), s_grown,
                                    state.s_eff))

    level = torch.as_tensor(level, dtype=torch.float32, device=dev)
    r_scaled = torch.clamp_min(state.relax_eff * level, ccfg.relax_floor)
    r_recovered = torch.clamp_max(state.relax_eff * 2.0, 1.0)
    relax_eff = torch.where(gmask & half, r_scaled,
                            torch.where(gmask & full, r_recovered,
                                        state.relax_eff))

    gain = torch.as_tensor(gain, dtype=torch.float32, device=dev)
    gain_ema = torch.where(
        gmask, ccfg.gain_ema * state.gain_ema + (1.0 - ccfg.gain_ema) * gain,
        state.gain_ema)
    return ControllerState(accepts, scaled, rejects, streak, gain_ema,
                           s_eff, relax_eff, state.ridge_eff)


def meta_update(state: ControllerState, jumped: Tuple[int, ...],
                g_relax, g_ridge, ccfg,
                groups: Sequence[sched_mod.GroupSchedule]
                ) -> ControllerState:
    """Sign-only meta-tuning fold: each jumped group's relax EMAs toward
    ``relax_floor`` when more jump hurts the gate loss (g_relax > 0) and
    toward 1 otherwise; its ridge toward 0 when more ridge hurts
    (g_ridge > 0) and toward ``ridge_max`` otherwise. Non-finite gradients
    and non-jumped groups leave the knobs untouched."""
    dev = state.relax_eff.device
    gmask = _group_mask(jumped, len(groups), dev)
    # fp32 as the reference's jnp.float32(meta_lr): 1 - lr rounds in fp32
    lr = torch.tensor(float(ccfg.meta_lr), dtype=torch.float32, device=dev)
    g_relax = torch.as_tensor(g_relax, dtype=torch.float32, device=dev)
    g_ridge = torch.as_tensor(g_ridge, dtype=torch.float32, device=dev)
    relax_tgt = torch.where(g_relax > 0,
                            torch.full_like(g_relax, ccfg.relax_floor),
                            torch.ones_like(g_relax))
    ridge_tgt = torch.where(g_ridge > 0, torch.zeros_like(g_ridge),
                            torch.full_like(g_ridge, ccfg.ridge_max))
    relax_new = (1.0 - lr) * state.relax_eff + lr * relax_tgt
    ridge_new = torch.clamp((1.0 - lr) * state.ridge_eff + lr * ridge_tgt,
                            0.0, ccfg.ridge_max)
    ok_relax = gmask & torch.isfinite(g_relax)
    ok_ridge = gmask & torch.isfinite(g_ridge)
    return state._replace(
        relax_eff=torch.where(ok_relax, relax_new, state.relax_eff),
        ridge_eff=torch.where(ok_ridge, ridge_new, state.ridge_eff))


def summary(state: ControllerState,
            groups: Sequence[sched_mod.GroupSchedule]) -> str:
    """Host-side table of the per-group state (logging)."""
    host = ControllerState(*(t.cpu()  # lint: allow-host-sync (logging)
                             for t in state))
    rows = [("group", "accepts", "scaled", "rejects", "streak",
             "gain_ema", "s_eff", "relax_eff", "ridge_eff")]
    for g in groups:
        i = g.index
        rows.append((g.name, str(int(host.accepts[i])),
                     str(int(host.scaled[i])), str(int(host.rejects[i])),
                     str(int(host.streak[i])),
                     f"{float(host.gain_ema[i]):.4f}",
                     f"{float(host.s_eff[i]):.1f}",
                     f"{float(host.relax_eff[i]):.3f}",
                     f"{float(host.ridge_eff[i]):.4f}"))
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    return "\n".join("  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip()
                     for r in rows)
