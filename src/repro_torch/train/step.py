"""Training-step helpers. So far: the post-jump optimizer-moment reset
for non-resident params. The fused train step and residency are still to
port (ROADMAP Queue 1)."""
from __future__ import annotations

from repro_torch.core.paths import by_path, map_with_paths


def reset_opt_state_after_jump(opt, opt_state, params, plans, groups,
                               n_groups):
    """Post-jump optimizer-moment reset.

    `groups` are the group indices whose moments reset (callers filter by
    each group's ``reset_opt``: ``DMDAccelerator.reset_groups``). When that
    covers every group this is a full ``opt.init``. Otherwise only those
    groups' leaves are reset in each params-shaped field of the state; other
    fields (scalar counters, empty states) are kept."""
    if groups is None or len(frozenset(groups)) >= n_groups:
        return opt.init(params)
    fresh = opt.init(params)
    gset = frozenset(int(g) for g in groups)
    plan_of = by_path(plans)
    param_paths = set(by_path(params))

    def merge(old_field, new_field):
        if not isinstance(old_field, dict) \
                or set(by_path(old_field)) != param_paths:
            return old_field
        new = by_path(new_field)

        def one(path, old):
            plan = plan_of.get(path)
            return new[path] if plan is not None and plan.group in gset \
                else old
        return map_with_paths(one, old_field)

    if isinstance(opt_state, dict):                # momentum-style state
        return merge(opt_state, fresh)
    if isinstance(opt_state, tuple):               # NamedTuple of fields
        return type(opt_state)(*(merge(o, n)
                                 for o, n in zip(opt_state, fresh)))
    return opt_state
