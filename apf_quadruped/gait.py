"""Gait schedules as static tables + jit-friendly time queries.

Batched replacement for the reference's GaitGenerator /
QuadrupedGaitGenerator (reference src/towr/quadruped_gait_generator.cc) and
the phase-based variable-node machinery it feeds: instead of per-phase
variable collapsing, a gait here is a fixed list of (duration, contact-mask)
phases; the MPC consumes fixed-shape per-knot boolean contact masks and the
tracker consumes per-leg phase queries — gait switching changes *data*
(a gait id), never shapes.

Leg order everywhere: (BR, BL, FL, FR).  The reference's towr EE binding is
(BL, BR, FL, FR) -> (LF, RF, LH, RH) (reference topt.cpp:31-38), so towr's
contact-state vocabulary translates as LF->BL, RF->BR, LH->FL, RH->FR.

Stride tables transcribed from quadruped_gait_generator.cc:103-458; combo
table (Stand prefix etc.) from :77-93; the per-call scaling of phase
durations to the replan horizon mirrors GetPhaseDurations as used by
topt.cpp:78-82.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

# Contact-state vocabulary in (BR, BL, FL, FR) order.
# Names follow towr's mnemonic (quadruped_gait_generator.cc:39-74), translated
# through the app's EE binding.
_B = {
    "II": (0, 0, 0, 0),
    "PI": (0, 0, 1, 0),   # stance {LH}={FL}
    "bI": (0, 0, 0, 1),   # {RH}={FR}
    "IP": (0, 1, 0, 0),   # {LF}={BL}
    "Ib": (1, 0, 0, 0),   # {RF}={BR}
    "Pb": (1, 0, 1, 0),   # {LH,RF}={FL,BR}
    "bP": (0, 1, 0, 1),   # {RH,LF}={FR,BL}
    "BI": (0, 0, 1, 1),   # {LH,RH}={FL,FR}
    "IB": (1, 1, 0, 0),   # {LF,RF}={BL,BR}
    "PP": (0, 1, 1, 0),   # {LH,LF}={FL,BL}
    "bb": (1, 0, 0, 1),   # {RH,RF}={FR,BR}
    "Bb": (1, 0, 1, 1),   # {LH,RH,RF}={FL,FR,BR}
    "BP": (0, 1, 1, 1),   # {LH,RH,LF}={FL,FR,BL}
    "bB": (1, 1, 0, 1),   # {RH,LF,RF}={FR,BL,BR}
    "PB": (1, 1, 1, 0),   # {LH,LF,RF}={FL,BL,BR}
    "BB": (1, 1, 1, 1),
}

Phase = Tuple[float, Tuple[int, int, int, int]]

# Stride library (durations in "canonical" seconds; scaled per use).
STRIDES: Dict[str, Tuple[Phase, ...]] = {
    "stand": ((0.3, _B["BB"]),),
    "flight": ((0.3, _B["Bb"]),),
    # trot: swing (BR, FL) then (BL, FR)  [GetStrideTrot :278-294]
    "trot": ((0.3, _B["bP"]), (0.2, _B["BB"]), (0.3, _B["Pb"]), (0.2, _B["BB"])),
    # trot2: opposite pair first  [GetStrideTrot2 :296-311]
    "trot2": ((0.3, _B["Pb"]), (0.2, _B["BB"]), (0.3, _B["bP"]), (0.2, _B["BB"])),
    # crawl walks, one swing leg at a time  [GetStrideWalk/2/3/4 :171-250]
    "walk1": ((0.3, _B["bB"]), (0.3, _B["BB"]), (0.3, _B["Bb"]), (0.3, _B["BB"]),
              (0.3, _B["PB"]), (0.3, _B["BB"]), (0.3, _B["BP"]), (0.3, _B["BB"])),
    "walk1_2": ((0.3, _B["Bb"]), (0.3, _B["BB"]), (0.3, _B["PB"]), (0.3, _B["BB"]),
                (0.3, _B["BP"]), (0.3, _B["BB"]), (0.3, _B["bB"]), (0.3, _B["BB"])),
    "walk1_3": ((0.3, _B["PB"]), (0.3, _B["BB"]), (0.3, _B["BP"]), (0.3, _B["BB"]),
                (0.3, _B["bB"]), (0.3, _B["BB"]), (0.3, _B["Bb"]), (0.3, _B["BB"])),
    "walk1_4": ((0.3, _B["BP"]), (0.3, _B["BB"]), (0.3, _B["bB"]), (0.3, _B["BB"]),
                (0.3, _B["Bb"]), (0.3, _B["BB"]), (0.3, _B["PB"]), (0.3, _B["BB"])),
    # overlap walk  [GetStrideWalkOverlap :251-276]
    "walk_overlap": ((0.25, _B["bB"]), (0.13, _B["bb"]), (0.25, _B["Bb"]),
                     (0.13, _B["Pb"]), (0.25, _B["PB"]), (0.13, _B["PP"]),
                     (0.25, _B["BP"]), (0.13, _B["bP"])),
    # flying trot [GetStrideTrotFly :313-330]
    "trot_fly": ((0.4, _B["bP"]), (0.1, _B["II"]), (0.4, _B["Pb"]), (0.1, _B["II"])),
    # pace [GetStridePace :347-363]
    "pace": ((0.3, _B["PP"]), (0.1, _B["II"]), (0.3, _B["bb"]), (0.1, _B["II"])),
    # bound [GetStrideBound :380-396]
    "bound": ((0.3, _B["BI"]), (0.1, _B["II"]), (0.3, _B["IB"]), (0.1, _B["II"])),
    # pronk [GetStridePronk :153-170]
    "pronk": ((0.3, _B["BB"]), (0.4, _B["II"]), (0.3, _B["BB"])),
    # gallop [GetStrideGallop :413-437]
    "gallop": ((0.2, _B["Bb"]), (0.3, _B["BI"]), (0.2, _B["BP"]), (0.2, _B["bP"]),
               (0.2, _B["bB"]), (0.3, _B["IB"]), (0.2, _B["PB"]), (0.2, _B["Pb"])),
    # limp [GetStrideLimp :439-456]
    "limp": ((0.1, _B["Bb"]), (0.2, _B["BB"]), (0.1, _B["IP"]),
             (0.1, _B["Bb"]), (0.2, _B["BB"]), (0.1, _B["IP"])),
}

# --- biped / monoped stride tables -------------------------------------
# Reference biped_gait_generator.cc / monoped_gait_generator.cc (the towr
# generators for the other model families, unused by the app but part of
# the library).  Zoo slot binding (models/zoo.py): biped L -> slot 1 (BL),
# R -> slot 0 (BR), front slots permanently masked; monoped -> slot 0.
_B2 = {"B": (1, 1, 0, 0), "P": (0, 1, 0, 0),   # P_ = stance left only
       "b": (1, 0, 0, 0), "I": (0, 0, 0, 0)}   # b_ = stance right only
_M1 = {"o": (1, 0, 0, 0), "x": (0, 0, 0, 0)}

STRIDES.update({
    # biped_gait_generator.cc:83-95 (stand) / 97-110 (flight)
    "biped_stand": ((0.2, _B2["B"]),),
    "biped_flight": ((0.5, _B2["I"]),),
    # GetStrideWalk :112-129: step 0.3 / stance 0.05, swing L then R
    "biped_walk": ((0.3, _B2["b"]), (0.05, _B2["B"]),
                   (0.3, _B2["P"]), (0.05, _B2["B"])),
    # GetStrideRun :131-148: pushoff 0.15, flight 0.4, landing 0.15
    "biped_run": ((0.15, _B2["b"]), (0.4, _B2["I"]), (0.3, _B2["P"]),
                  (0.4, _B2["I"]), (0.15, _B2["b"])),
    # GetStrideHop :150-166
    "biped_hop": ((0.15, _B2["B"]), (0.5, _B2["I"]), (0.15, _B2["B"])),
    # GetStrideGallopHop :168-189
    "biped_gallop_hop": ((0.2, _B2["P"]), (0.3, _B2["I"]),
                         (0.2, _B2["b"]), (0.2, _B2["B"])),
    # GetStrideLeftHop :191-206 / GetStrideRightHop :208-225
    "biped_left_hop": ((0.15, _B2["b"]), (0.4, _B2["I"]), (0.15, _B2["b"])),
    "biped_right_hop": ((0.2, _B2["P"]), (0.2, _B2["I"]), (0.2, _B2["P"])),
    # monoped_gait_generator.cc:63-90 (stand/flight), 92-106 (hop),
    # 108-121 (hop long)
    "mono_stand": ((0.5, _M1["o"]),),
    "mono_flight": ((0.5, _M1["x"]),),
    "mono_hop": ((0.3, _M1["o"]), (0.3, _M1["x"])),
    "mono_hop_long": ((0.2, _M1["o"]), (0.3, _M1["x"])),
})

# Gait-flag combos: reference gait_flag -> stride sequence, each prefixed with a
# stand phase (SetCombo, quadruped_gait_generator.cc:77-93; flag mapping
# topt.cpp:49-79).  Flag 0 = pure stand (our addition for convenience).
GAIT_FLAG_COMBOS: Dict[int, Tuple[str, ...]] = {
    0: ("stand",),
    1: ("stand", "trot"),      # C1
    2: ("stand", "trot2"),     # C5
    3: ("stand",),             # C6
    4: ("stand", "walk1_4"),   # C9
    5: ("stand", "walk1_2"),   # C7
    6: ("stand", "walk1"),     # C10
    7: ("stand", "walk1_3"),   # C8
    # biped combos (biped_gait_generator.cc:52-59: Stand + stride cycles)
    8: ("biped_stand", "biped_walk"),                      # biped C0
    9: ("biped_stand", "biped_run"),                       # biped C1
    10: ("biped_stand", "biped_hop"),                      # biped C2
    11: ("biped_stand", "biped_left_hop", "biped_right_hop"),  # biped C3
    12: ("biped_stand", "biped_gallop_hop"),               # biped C4
    # monoped combos (monoped_gait_generator.cc:38-46)
    13: ("mono_stand", "mono_hop"),                        # monoped C0-C2
    14: ("mono_stand", "mono_hop_long"),                   # monoped C3/C4
    # full trot cycle: pair A then pair B in ONE table entry — phase-for-
    # phase identical to two consecutive 0.5 s C1/C5 replans when scaled
    # to 1.0 s.  Used by the adaptive gait mode so trot and crawl share a
    # cycle length and the robustness switch is pure data (a flag select).
    15: ("stand", "trot", "stand", "trot2"),
    # ---- the remaining transcribed quadruped strides, each behind its
    # own flag (reference quadruped_gait_generator.cc:153-456 ships them
    # in the stride library but SetCombo never wires them; here every
    # stride is executable).  Flight-phase gaits (trot_fly, pace, bound,
    # pronk, gallop) produce all-swing knots — the MPC's zero-contact
    # case, which trot never exercises.
    16: ("stand", "walk_overlap"),
    17: ("stand", "trot_fly"),
    18: ("stand", "pace"),
    19: ("stand", "bound"),
    20: ("stand", "pronk"),
    21: ("stand", "gallop"),
    22: ("stand", "limp"),
}

# closed-loop gait-mode names -> fixed gait flag (GaitConfig.mode; the
# trot/crawl/adaptive modes keep their dedicated loop logic)
NAMED_MODE_FLAGS: Dict[str, int] = {
    "walk_overlap": 16,
    "trot_fly": 17,
    "pace": 18,
    "bound": 19,
    "pronk": 20,
    "gallop": 21,
    "limp": 22,
}

MAX_PHASES = 16
NUM_GAITS = len(GAIT_FLAG_COMBOS)


def _combo_phases(names: Sequence[str]) -> Tuple[Phase, ...]:
    out = []
    for n in names:
        out.extend(STRIDES[n])
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class GaitTable:
    """Packed, padded phase tables for all gait flags (static arrays).

    durations: (NUM_GAITS, MAX_PHASES) normalized phase durations (sum = 1)
    contacts:  (NUM_GAITS, MAX_PHASES, 4) stance masks
    n_phases:  (NUM_GAITS,)
    Padding phases have zero duration and full-stance contact, so time
    queries past the horizon return "stand".
    """

    durations: np.ndarray
    contacts: np.ndarray
    n_phases: np.ndarray


def build_gait_table() -> GaitTable:
    durations = np.zeros((NUM_GAITS, MAX_PHASES))
    contacts = np.ones((NUM_GAITS, MAX_PHASES, 4))
    n_phases = np.zeros(NUM_GAITS, dtype=np.int32)
    for flag, names in GAIT_FLAG_COMBOS.items():
        phases = _combo_phases(names)
        total = sum(d for d, _ in phases)
        n_phases[flag] = len(phases)
        for i, (d, c) in enumerate(phases):
            durations[flag, i] = d / total
            contacts[flag, i] = c
    return GaitTable(durations=durations, contacts=contacts, n_phases=n_phases)


_TABLE = build_gait_table()


def gait_arrays(dtype=jnp.float32):
    """(durations, contacts) as device arrays."""
    return (jnp.asarray(_TABLE.durations, dtype=dtype),
            jnp.asarray(_TABLE.contacts, dtype=dtype))


def contact_state(gait_flag: jnp.ndarray, t: jnp.ndarray, cycle: jnp.ndarray,
                  dtype=jnp.float32) -> jnp.ndarray:
    """(…, 4) stance mask at time t (seconds since replan start) for the given
    gait flag and cycle duration.  All args broadcastable; jit/vmap-safe.

    Equivalent to sampling towr's phase sequence scaled to `cycle`
    (GetPhaseDurations; topt.cpp:78-82).  t beyond the cycle -> full stance.
    """
    durs, cons = gait_arrays(dtype)
    d = durs[gait_flag]                                # (..., MAX_PHASES)
    c = cons[gait_flag]                                # (..., MAX_PHASES, 4)
    edges = jnp.cumsum(d, axis=-1) * cycle[..., None]  # phase end times
    tt = t[..., None]
    idx = jnp.sum((tt >= edges).astype(jnp.int32), axis=-1)
    idx = jnp.clip(idx, 0, MAX_PHASES - 1)
    return jnp.take_along_axis(c, idx[..., None, None], axis=-2)[..., 0, :]


def phase_info(gait_flag: jnp.ndarray, t: jnp.ndarray, cycle: jnp.ndarray,
               dtype=jnp.float32):
    """Per-leg phase query at time t.

    Returns dict with:
      contact   (…, 4)  current stance mask
      t_start   (…, 4)  start time of the current *per-leg* phase (merging
                        consecutive phases with equal contact state for that
                        leg, like towr's per-EE phase durations)
      t_end     (…, 4)  end time of the current per-leg phase

    The merged boundaries are what swing-trajectory generation needs: a leg's
    swing phase runs [t_start, t_end) whenever contact == 0.
    """
    import jax

    durs, cons = gait_arrays(dtype)
    d = durs[gait_flag] * cycle[..., None]             # (..., P)
    c = cons[gait_flag]                                # (..., P, 4)
    ends = jnp.cumsum(d, axis=-1)                      # (..., P)
    starts = ends - d
    tt = t[..., None]
    # Index of the phase containing t; t beyond the cycle -> last phase.
    idx = jnp.sum((tt >= ends).astype(jnp.int32), axis=-1)
    idx = jnp.clip(idx, 0, MAX_PHASES - 1)
    cur = jnp.take_along_axis(c, idx[..., None, None], axis=-2)[..., 0, :]  # (...,4)

    # Per-leg merged runs of equal contact state.  For each phase p (per leg):
    #   run_start_idx[p] = largest q <= p where contact changed at q (cummax)
    #   run_end_idx[p]   = smallest q >= p where contact changes after q
    #                      (reverse cummin)
    leg_c = jnp.moveaxis(c, -1, -2)                    # (..., 4, P)
    pos = jnp.arange(MAX_PHASES)
    prev_same = jnp.concatenate(
        [jnp.zeros(leg_c.shape[:-1] + (1,), dtype=bool),
         leg_c[..., 1:] == leg_c[..., :-1]], axis=-1)
    next_same = jnp.concatenate(
        [leg_c[..., 1:] == leg_c[..., :-1],
         jnp.zeros(leg_c.shape[:-1] + (1,), dtype=bool)], axis=-1)
    ax = leg_c.ndim - 1  # associative_scan needs a nonnegative axis
    run_start_idx = jax.lax.associative_scan(
        jnp.maximum, jnp.where(prev_same, -1, pos), axis=ax)
    run_end_idx = jax.lax.associative_scan(
        jnp.minimum, jnp.where(next_same, MAX_PHASES, pos), axis=ax,
        reverse=True)

    idx4 = jnp.broadcast_to(idx[..., None], idx.shape + (4,))  # (..., 4)
    sel = lambda arr: jnp.take_along_axis(arr, idx4[..., None], axis=-1)[..., 0]
    rs = sel(run_start_idx)                            # (..., 4)
    re = sel(run_end_idx)
    starts4 = jnp.broadcast_to(starts[..., None, :], leg_c.shape)
    ends4 = jnp.broadcast_to(ends[..., None, :], leg_c.shape)
    t_start = jnp.take_along_axis(starts4, rs[..., None], axis=-1)[..., 0]
    t_end = jnp.take_along_axis(ends4, re[..., None], axis=-1)[..., 0]
    return {"contact": cur, "t_start": t_start, "t_end": t_end}


def horizon_contacts(gait_flag: jnp.ndarray, t0: jnp.ndarray, dt: float,
                     horizon: int, cycle: jnp.ndarray,
                     dtype=jnp.float32) -> jnp.ndarray:
    """(…, H, 4) stance masks at knot midpoints t0 + (k+0.5) dt — the MPC's
    contact schedule (fixed shape; the batched replacement for towr's phase-based
    node structure)."""
    k = jnp.arange(horizon, dtype=dtype)
    tk = t0[..., None] + (k + 0.5) * dt
    return contact_state(gait_flag[..., None], tk, cycle[..., None], dtype=dtype)
