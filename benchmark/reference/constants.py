"""Constants of the legged-MPC problem.

A copy of `legged_mpc_control_tpu/constants.py` (the reference's
LeggedParams.h:6-30), kept here so the PyTorch package imports nothing of the
JAX package. Horizon and substep counts are defaults; every function takes
them as arguments.
"""

# --- control rates (seconds) ---
# reference: LeggedParams.h:7-9 (10 ms MPC tick, 1.25 ms low-level/feedback)
MPC_DT = 0.01
LOW_LEVEL_DT = 0.00125
FEEDBACK_DT = 0.00125
# low-level substeps per MPC tick (10 ms / 1.25 ms)
SUBSTEPS_PER_MPC_TICK = 8

# --- MPC problem dims ---
# reference: LeggedParams.h:12-15
PLAN_HORIZON = 30
MPC_STATE_DIM = 12          # [rpy(3), pos(3), omega_world(3), v_world(3)]
                            # reference: ConvexQPSolver.cpp:256-259
DIM_GRF = 12                # 4 legs x 3D ground reaction force

# --- robot dims ---
NUM_LEG = 4
NUM_DOF_PER_LEG = 3
NUM_DOF = 12

# --- swing trajectory ---
# reference: LeggedParams.h:26-27
FOOT_SWING_CLEARANCE1 = 0.0
FOOT_SWING_CLEARANCE2 = 0.23

# --- Raibert foothold clamp ---
# reference: LeggedParams.h:29-30
FOOT_DELTA_X_LIMIT = 0.8
FOOT_DELTA_Y_LIMIT = 0.8

# --- gravity ---
GRAVITY = 9.8               # used inside the MPC dynamics
                            # reference: ConvexQPSolver.cpp:175, 296
GRAVITY_EST = 9.81          # used inside the state estimator
                            # reference: BasicKF.cpp:78

# leg order everywhere: 0-FL, 1-FR, 2-RL, 3-RR
# reference: BaseInterface.cpp:75
LEG_NAMES = ("FL", "FR", "RL", "RR")
