"""Gait engine (`legged_mpc_control_tpu/mpc/gait.py`): the reference's
per-leg SWING/STANCE FSM (LeggedContactFSM.cpp) as phase arithmetic,
batched over (B, 4) scenarios x legs. Every branch is a `torch.where`.

A pattern is a per-leg segment table shared by the batch:
    seg_state (4, MAX_SEG) int32 in {SWING, STANCE}
    switch_time (4, MAX_SEG): phase at which segment s ends (pad 1.0)
    n_seg (4,) int32
The named gaits of the reference's gait library are in `NAMED_PATTERNS`
(`named_pattern`); their tables are built on the host and copied to the
device once.
"""

from dataclasses import dataclass

import torch

from benchmark.reference.config import resolve_device
from benchmark.reference.ops.bezier import swing_foot_pos
from benchmark.reference.tree import Struct

MAX_SEG = 12
SWING = 0
STANCE = 1


@dataclass
class GaitPattern(Struct):
    seg_state: torch.Tensor     # int32 (4, MAX_SEG)
    switch_time: torch.Tensor   # (4, MAX_SEG)
    n_seg: torch.Tensor         # int32 (4,)


def _pattern(per_leg, dtype, device):
    """The tables of per-leg lists of (state, end phase) segments, built on
    the host and copied to `device` once."""
    device = resolve_device(device)
    seg = torch.zeros((4, MAX_SEG), dtype=torch.int32)
    sw = torch.ones((4, MAX_SEG), dtype=dtype)
    n = torch.zeros((4,), dtype=torch.int32)
    for leg, segments in enumerate(per_leg):
        for s, (st, et) in enumerate(segments):
            seg[leg, s] = st
            sw[leg, s] = et
        seg[leg, len(segments):] = segments[-1][0]
        n[leg] = len(segments)
    return GaitPattern(seg_state=seg.to(device), switch_time=sw.to(device),
                       n_seg=n.to(device))


def trot_pattern(dtype=torch.float32, device="cuda") -> GaitPattern:
    """Default trot, FL/RR stance first (reference:
    LeggedContactFSM.cpp:93-114)."""
    diag_a = [(STANCE, 0.5), (SWING, 1.0)]
    diag_b = [(SWING, 0.5), (STANCE, 1.0)]
    return _pattern([diag_a, diag_b, diag_b, diag_a], dtype, device)


# the named gait the cells run (the port's table has the reference's
# whole gait library)
NAMED_PATTERNS = {"trot": trot_pattern}


def named_pattern(name: str, dtype=torch.float32,
                  device="cuda") -> GaitPattern:
    """A gait of `NAMED_PATTERNS` by name (config tier 3, gait.info)."""
    try:
        make = NAMED_PATTERNS[name]
    except KeyError:
        raise ValueError(f"unknown gait '{name}'; known: "
                         f"{sorted(NAMED_PATTERNS)}") from None
    return make(dtype, device)


@dataclass
class GaitLegState(Struct):
    """FSM state, leaves (B, 4, ...) (reference: LeggedContactFSM.h)."""
    phase: torch.Tensor
    state: torch.Tensor              # int32 SWING / STANCE
    pattern_idx: torch.Tensor        # int32
    cur_start: torch.Tensor
    cur_end: torch.Tensor
    swing_start_pos: torch.Tensor    # (B,4,3)
    swing_end_pos: torch.Tensor      # (B,4,3)
    target_pos: torch.Tensor         # (B,4,3) FSM_foot_pos_target_world
    target_vel: torch.Tensor         # (B,4,3)
    terrain_height: torch.Tensor
    initialized: torch.Tensor        # bool


def _lookup(table, idx):
    """table (4, MAX_SEG) at per-leg indices idx (..., 4), gathered on the
    table's device."""
    return table.expand(idx.shape + (MAX_SEG,)).gather(
        -1, idx.long()[..., None])[..., 0]


def gait_leg_init(pattern: GaitPattern, batch: int,
                  dtype=torch.float32) -> GaitLegState:
    """Fresh FSM state (reference: LeggedContactFSM.cpp:5-36), on the
    pattern's device."""
    device = pattern.switch_time.device

    def z(*shape, dt=dtype):
        return torch.zeros((batch, 4) + shape, dtype=dt, device=device)
    return GaitLegState(
        phase=z(),
        state=pattern.seg_state[:, 0].expand(batch, 4).clone(),
        pattern_idx=z(dt=torch.int32),
        cur_start=z(),
        cur_end=pattern.switch_time[:, 0].expand(batch, 4).clone(),
        swing_start_pos=z(3), swing_end_pos=z(3),
        target_pos=z(3), target_vel=z(3),
        terrain_height=z(),
        initialized=z(dt=torch.bool))


def gait_leg_reset(s: GaitLegState, pattern: GaitPattern) -> GaitLegState:
    """Reset on entering stand mode (reference: LeggedContactFSM.cpp:16-36):
    stance feet hold, swing feet jump to their saved target."""
    was_swing = (s.state == SWING)[..., None]
    B = s.phase.shape[0]
    return s.replace(
        phase=torch.zeros_like(s.phase),
        state=pattern.seg_state[:, 0].expand(B, 4).clone(),
        pattern_idx=torch.zeros_like(s.pattern_idx),
        cur_start=torch.zeros_like(s.cur_start),
        cur_end=pattern.switch_time[:, 0].expand(B, 4).clone(),
        target_pos=torch.where(was_swing, s.swing_end_pos, s.target_pos),
        target_vel=torch.where(was_swing, torch.zeros_like(s.target_vel),
                               s.target_vel),
        initialized=torch.zeros_like(s.initialized))


def _percent_in_state(s: GaitLegState):
    """reference: LeggedContactFSM.cpp:269-278."""
    pct = (s.phase - s.cur_start) / (s.cur_end - s.cur_start)
    return torch.clamp(pct, 0.0, 1.0)


def _where(cond, a: GaitLegState, b: GaitLegState) -> GaitLegState:
    """Per-(scenario, leg) select between two states."""
    out = {}
    for name in a.__dataclass_fields__:
        x, y = getattr(a, name), getattr(b, name)
        c = cond if x.dim() == cond.dim() else cond[..., None]
        out[name] = torch.where(c, x, y)
    return GaitLegState(**out)


def gait_leg_update(s: GaitLegState, pattern: GaitPattern, dt, gait_speed,
                    foot_pos_cur, foot_pos_target,
                    foot_force_flag) -> GaitLegState:
    """One FSM tick for every leg (reference: LeggedContactFSM.cpp:38-84).
    gait_speed (B,); foot_pos_* (B,4,3); foot_force_flag (B,4) bool."""
    first = (~s.initialized)[..., None]
    s = s.replace(
        swing_start_pos=torch.where(first, foot_pos_cur, s.swing_start_pos),
        swing_end_pos=torch.where(first, foot_pos_target, s.swing_end_pos),
        target_pos=torch.where(first, foot_pos_target, s.target_pos),
        target_vel=torch.where(first, torch.zeros_like(s.target_vel),
                               s.target_vel),
        initialized=torch.ones_like(s.initialized))
    s = s.replace(phase=s.phase + gait_speed[:, None] * dt)

    pct = _percent_in_state(s)
    seg_end = torch.where(s.state == STANCE, s.phase >= s.cur_end,
                          ((pct > 0.9) & foot_force_flag) | (pct >= 1.0))

    # _common_enter (reference: :214-229, `<=` so a one-segment pattern
    # also wraps its phase)
    nxt = (s.pattern_idx + 1) % pattern.n_seg
    wrapped = nxt <= s.pattern_idx
    phase = torch.where(wrapped, s.phase - 1.0, s.phase)
    entered = s.replace(pattern_idx=nxt, phase=phase, cur_start=phase,
                        cur_end=_lookup(pattern.switch_time, nxt))
    next_state = _lookup(pattern.seg_state, nxt)
    enter_swing = seg_end & (next_state == SWING)
    enter_stance = seg_end & (next_state == STANCE) & (s.state == SWING)
    swing_entered = entered.replace(
        state=torch.full_like(s.state, SWING),
        terrain_height=foot_pos_cur[..., 2],
        swing_start_pos=foot_pos_cur)
    stance_entered = entered.replace(
        state=torch.full_like(s.state, STANCE),
        target_pos=foot_pos_cur,
        target_vel=torch.zeros_like(s.target_vel))
    rebook = entered.replace(state=torch.full_like(s.state, STANCE))
    s = _where(seg_end, rebook, s)
    s = _where(enter_stance, stance_entered, s)
    s = _where(enter_swing, swing_entered, s)

    # swing: Bezier toward the target, velocity by finite difference
    # (reference: :242-254); stance: hold (:256-267)
    pct = _percent_in_state(s)
    bez = swing_foot_pos(pct, s.swing_start_pos, foot_pos_target)
    in_swing = (s.state == SWING)[..., None]
    new_target = torch.where(in_swing, bez, s.target_pos)
    new_vel = torch.where(in_swing, (new_target - s.target_pos) / dt,
                          s.target_vel)
    return s.replace(
        swing_end_pos=torch.where(in_swing, foot_pos_target,
                                  s.swing_end_pos),
        target_pos=new_target, target_vel=new_vel)


def get_contact_state(s: GaitLegState):
    """1.0 where the FSM is in STANCE: (B, 4)."""
    return (s.state == STANCE).to(s.phase.dtype)


def predict_contact_state(s: GaitLegState, pattern: GaitPattern, dt_ahead,
                          gait_speed):
    """Contact flag `dt_ahead` seconds ahead from the pattern table
    (reference: LeggedContactFSM.cpp:280-294): (B, 4)."""
    p = s.phase + gait_speed[:, None] * dt_ahead
    p = torch.where(p > 1.0, p - torch.ceil(p - 1.0), p)
    sw = pattern.switch_time                                  # (4, MAX_SEG)
    valid = torch.arange(MAX_SEG, device=sw.device) < pattern.n_seg[:, None]
    idx = ((p[..., None] > sw) & valid).sum(dim=-1)
    idx = torch.minimum(idx, (pattern.n_seg - 1).long())
    return (_lookup(pattern.seg_state, idx) == STANCE).to(s.phase.dtype)
