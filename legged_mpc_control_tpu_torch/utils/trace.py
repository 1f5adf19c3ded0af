"""The port's layer spans: a named host range around each layer of a tick,
recorded only while a `torch.profiler` profile is recording.

`span(name)` is a context manager. With a profiler on it opens a record
function named "lmpc.<name>" on the host; otherwise it is one shared null
context, and the call costs the read of one flag. It touches no tensor,
adds no device operation and never waits on the device. `spanned(name)`
wraps a function in it.

The record function is PyTorch's fast form, whose scope is a function's:
the profiler keeps its host range, and copies to the device's timeline
only the ranges of `torch.profiler.record_function` (a user scope), so a
span never reads as device work in a trace.

The spans nest as the layers call each other:

    lmpc.tick                  control/step: the tick entry points
      lmpc.feedback_update     control/step: the feedback pass
      lmpc.mpc_prepare         mpc/convex_mpc: before the QP solve
      lmpc.k1                  ops/riccati_kernel: the Riccati IPM (K1)
      lmpc.qp_condense         mpc/convex_mpc: the condensed QP's build
      lmpc.admm                mpc/admm: the ADMM solve
        lmpc.k4                ops/chol_kernel: the Cholesky factor (K4)
        lmpc.k5                ops/chol_kernel: the Cholesky solve (K5)
      lmpc.mpc_finish          mpc/convex_mpc: after it
      lmpc.lci_seam            mpc/lci_mpc: the LCI seam
        lmpc.ci_prep           mpc/ci_mpc: the CI walk's prep
        lmpc.ci_solve          mpc/ci_mpc: the CI solve's set-up and sweeps
          lmpc.k7              ops/ci_kernel: the CI sweeps (K7)
        lmpc.ci_post           mpc/ci_mpc: the CI walk's post
      lmpc.k2                  control/step: the substep chain (K2 / K3)
      lmpc.feedback_unpack     control/step: the chain's Feedback block

K4 and K5 carry their spans wherever they are called (the PDIP solve, the
articulated twin, the LCI walk), not only inside the ADMM solve.
"""

import contextlib
import functools

import torch
from torch.autograd import profiler as _profiler

PREFIX = "lmpc."

TICK = "tick"
FEEDBACK_UPDATE = "feedback_update"
MPC_PREPARE = "mpc_prepare"
MPC_FINISH = "mpc_finish"
K1 = "k1"
K2 = "k2"
FEEDBACK_UNPACK = "feedback_unpack"
LCI_SEAM = "lci_seam"
CI_PREP = "ci_prep"
CI_SOLVE = "ci_solve"
CI_POST = "ci_post"
K7 = "k7"
QP_CONDENSE = "qp_condense"
ADMM = "admm"
K4 = "k4"
K5 = "k5"

NAMES = (TICK, FEEDBACK_UPDATE, MPC_PREPARE, MPC_FINISH, K1, K2,
         FEEDBACK_UNPACK, LCI_SEAM, CI_PREP, CI_SOLVE, CI_POST, K7,
         QP_CONDENSE, ADMM, K4, K5)

_OFF = contextlib.nullcontext()


def span(name):
    """The host range "lmpc.<name>" while a profiler records, else the
    shared null context."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch._C._profiler._RecordFunctionFast(PREFIX + name)


def spanned(name):
    """Decorator: run the function inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap
