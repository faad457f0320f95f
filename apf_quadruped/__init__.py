"""apf_quadruped — a batched quadruped MPC / trajectory-optimization engine.

A from-scratch JAX/XLA re-design of the capabilities of
prisma-lab/APF_quadruped: single-rigid-body centroidal
MPC with gait-scheduled stance/swing contacts, artificial-potential-field
(attractive + slippage-aware repulsive) navigation, and a friction-cone +
torque-limit whole-body tracking QP, solved by a batched dense predictor-
corrector interior-point method.

Instead of the reference's single-robot ROS/Gazebo loop (C++/qpSWIFT/TOWR),
everything here is a pure function of arrays: vmap over thousands of
scenarios per device, shard over a multi-device mesh with XLA collectives,
and close the loop through a pure-JAX simulation harness.

Layer map (mirrors SURVEY.md §1 of the reference analysis):
    sim/          — Gazebo replacement: pure-JAX physics + mu/height terrain
    apf.py        — L6 navigation: per-foot potential fields + robustness index
    foothold.py   — L6/L5 terrain-scored foothold selection (towr's
                    foothold-optimization role inside the RoM box)
    planner.py    — L5 trajectory optimization: SRB MPC (replaces TOWR+IPOPT;
                    opt-in base_box / base_acc constraint analogues)
    wbc.py        — L4 whole-body tracking QP (replaces the 5 inlined qpSWIFT QPs)
    ops/qpsolve.py— L3 QP solver (replaces qpSWIFT: batched dense Mehrotra IPM)
    ops/riccati.py
                  — L3 structure-exploiting horizon solver (banded Riccati
                    IPM, warm starting, state/accel rows)
    models/       — L2 dynamics model (replaces iDynTree: SRB + leg kinematics)
    gait.py       — the FULL stride library as executable flags (trot, crawls,
                    walk_overlap, trot_fly, pace, bound, pronk, gallop, limp,
                    biped/monoped)
    runtime/      — closed loop (with the in-loop momentum observer), batched
                    sweeps with checkpoint/resume, metrics, viz, native bindings
    parallel/     — scenario-axis sharding over device meshes
"""

__version__ = "0.1.0"
