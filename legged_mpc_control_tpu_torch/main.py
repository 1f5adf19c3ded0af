"""Process entry point — the `main.cpp` equivalent, the port of
`legged_mpc_control_tpu/main.py`.

The reference's main (reference: src/legged_ctrl/src/main.cpp:24-256) reads
`/use_sim_time`, `/robot_type`, `/mpc_type` params, instantiates the
interface + MPC, and spawns three real-time threads. Here the same selectors
become CLI flags, the threads are one closed-loop step a tick, and the
"rosbag" is a structured .npz diagnostics bag.

Usage (on the card; `--cpu` runs on the CPU):
    python -m legged_mpc_control_tpu_torch --robot a1 --mpc convex --kf 0 \
        --seconds 2.0 --bag /tmp/run.npz

Exit codes: 0 upright at the end; 1 the hardware interlocks (an unconfirmed
run, kf_type 0 on hardware); 2 the robot fell, or the arguments were
refused (no card without `--cpu`, `--f64` without `--cpu`); 3 a safety stop
on hardware.
"""

import argparse
import json
import os
import sys
import time


def build_parser():
    p = argparse.ArgumentParser(
        prog="legged_mpc_control_tpu_torch",
        description="PyTorch/CUDA legged convex-MPC runtime")
    p.add_argument("--robot", choices=["a1", "go1"], default="a1",
                   help="robot_type (reference: main.cpp:36-44)")
    p.add_argument("--mpc", choices=["convex", "lci", "ci"],
                   default="convex",
                   help="mpc_type 1=convex, 0=lci (reference: main.cpp:113)"
                        "; 'ci' runs the true contact-implicit optimizer "
                        "(mpc/ci_mpc.py) in the lci seam")
    p.add_argument("--kf", type=int, choices=[0, 1, 2], default=0,
                   help="kf_type: 0 ground truth (sim only), 1 linear KF, "
                        "2 EKF (reference: BaseInterface.cpp:404-449)")
    p.add_argument("--backend", choices=["sim", "hardware"], default="sim")
    p.add_argument("--wire", choices=["native", "unitree"],
                   default="native",
                   help="hardware wire protocol: 'native' (framework "
                        "runtime packets, loopback HIL) or 'unitree' "
                        "(real unitree_legged_sdk v3.2 LowCmd/LowState, "
                        "reference: HardwareInterface.cpp:7)")
    p.add_argument("--robot-ip", default="127.0.0.1",
                   help="robot address (Unitree low-level default "
                        "192.168.123.10)")
    p.add_argument("--robot-port", type=int, default=8007)
    p.add_argument("--gait", default="trot",
                   help="named gait (gait.info equivalent): trot, "
                        "standing_trot, flying_trot, pace, crawl, bound, "
                        "pronk, stance, ...")
    p.add_argument("--config", default=None,
                   help="YAML variant file (configs/*.yaml); overrides "
                        "--robot and parameter defaults")
    p.add_argument("--low-level", type=int, choices=[0, 1], default=0,
                   dest="low_level",
                   help="low_level_type: 0 J^T tau control, 1 hierarchical "
                        "WBC (reference: LeggedState.h:149)")
    p.add_argument("--horizon", type=int, default=10)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--height", type=float, default=0.3)
    p.add_argument("--velx", type=float, default=0.0,
                   help="forward velocity command; nonzero switches to walk")
    p.add_argument("--bag", default=None, help="write diagnostics .npz here")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the run "
                        "into DIR (trace.json; open in Perfetto or "
                        "chrome://tracing)")
    p.add_argument("--tune-port", type=int, default=None, dest="tune_port",
                   help="listen for live parameter updates (UDP JSON) on "
                        "this port — the reference's low_level_gains "
                        "channel (BaseInterface.cpp:147-162); push with "
                        "utils.tuning.send_gains")
    p.add_argument("--joy-port", type=int, default=None, dest="joy_port",
                   help="listen for live gamepad frames (UDP JSON) on this "
                        "port — the reference's /joy subscription "
                        "(BaseInterface.cpp:122-145); push with "
                        "interfaces.joystick.send_joy")
    p.add_argument("--f64", action="store_true",
                   help="run in float64 (with --cpu only: the card's "
                        "kernels are float32)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    p.add_argument("--yes", action="store_true",
                   help="skip the hardware confirmation prompt "
                        "(reference: main.cpp:57-60)")
    return p


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.f64 and not args.cpu:
        parser.error("--f64 needs --cpu: the card's kernels are float32 and "
                     "refuse float64")

    import torch

    if not args.cpu and not torch.cuda.is_available():
        parser.error("no CUDA device available: pass --cpu to run on the "
                     "CPU")

    from legged_mpc_control_tpu_torch import constants as C
    from legged_mpc_control_tpu_torch.config import a1_params, go1_params
    from legged_mpc_control_tpu_torch.mpc import gait as gait_mod
    from legged_mpc_control_tpu_torch.utils import bag as bag_mod

    if args.backend == "hardware" and not args.yes:
        # reference: hardware confirmation prompt, main.cpp:57-60
        reply = input("About to drive REAL hardware. Type 'yes' to "
                      "continue: ")
        if reply.strip().lower() != "yes":
            print("aborted")
            return 1
    if args.backend == "hardware" and args.kf == 0:
        # reference interlock: hardware requires estimation, main.cpp:97-100
        print("error: kf_type 0 (ground-truth bypass) is sim-only",
              file=sys.stderr)
        return 1
    if args.mpc == "lci":
        print("LCI-MPC backend: built-in stand + trot-walk policies "
              "through the pluggable policy seam (mpc/lci_mpc.py)")
    elif args.mpc == "ci":
        print("contact-implicit MPC backend: FB-complementarity iLQR "
              "(mpc/ci_mpc.py) through the policy seam, warm-started "
              "across ticks")

    device = torch.device("cpu" if args.cpu else "cuda")
    dtype = torch.float64 if args.f64 else torch.float32
    if args.config:
        from legged_mpc_control_tpu_torch.config import load_yaml_params

        params = load_yaml_params(args.config, dtype, device)
    else:
        params = (a1_params if args.robot == "a1" else go1_params)(
            dtype, device)
    pattern = gait_mod.named_pattern(args.gait, dtype, device)

    if args.backend == "hardware":
        return _run_hardware(args, params, pattern, dtype, device)

    from legged_mpc_control_tpu_torch.interfaces.sim_iface import (
        SimInterface,
    )

    iface = SimInterface(params, pattern, dtype=dtype, height=args.height,
                         body_height=args.height, horizon=args.horizon,
                         kf_type=args.kf, mpc_type=args.mpc,
                         low_level_type=args.low_level,
                         walk_velx=(args.velx or 0.25), device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    n_ticks = int(args.seconds / C.MPC_DT)
    records = []
    tick_wall_ms = []
    tuner = None
    if args.tune_port is not None:
        from legged_mpc_control_tpu_torch.utils.tuning import GainTuner

        tuner = GainTuner(bind=("127.0.0.1", args.tune_port)).start()
    joy_src = None
    if args.joy_port is not None:
        from legged_mpc_control_tpu_torch.interfaces.joystick import (
            UdpJoystick,
        )

        joy_src = UdpJoystick(bind=("127.0.0.1", args.joy_port)).start()
    prof = None
    if args.profile:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    t0 = time.perf_counter()
    try:
        for i in range(n_ticks):
            if joy_src is not None:
                # live operator input through the joy FSM
                # (reference: joy_update, BaseInterface.cpp:165-209)
                from legged_mpc_control_tpu_torch.control import joy as joy_mod

                axes, buttons = joy_src.get()
                cs = joy_mod.joy_update(iface.loop.controller, axes[None],
                                        buttons[None], C.MPC_DT, params)
                iface.loop = iface.loop.replace(controller=cs)
                if bool(cs.joy.exit_flag[0]):
                    print("operator exit", file=sys.stderr)
                    break
            elif args.velx != 0.0 and i == min(20, n_ticks // 4):
                cs = iface.loop.controller
                cs = cs.replace(
                    ctrl=cs.ctrl.replace(movement_mode=torch.ones_like(
                        cs.ctrl.movement_mode)),
                    joy=cs.joy.replace(
                        velx=torch.full_like(cs.joy.velx, args.velx),
                        ctrl_state=torch.ones_like(cs.joy.ctrl_state)))
                iface.loop = iface.loop.replace(controller=cs)
            if tuner is not None:
                iface.params = tuner.apply(iface.params)
            t_tick = time.perf_counter()
            iface.tick()
            if args.bag:
                sync()
                tick_wall_ms.append(
                    (time.perf_counter() - t_tick) * 1e3)
                records.append({
                    k: v.detach().cpu().numpy() for k, v in
                    bag_mod.diag_from_loop(iface.loop).items()})
    finally:
        if prof is not None:
            sync()
            prof.__exit__(None, None, None)
            os.makedirs(args.profile, exist_ok=True)
            prof.export_chrome_trace(os.path.join(args.profile,
                                                  "trace.json"))
        if tuner is not None:
            tuner.close()
        if joy_src is not None:
            joy_src.close()
    sync()
    wall = time.perf_counter() - t0

    loop = iface.loop
    pos = loop.sim.pos[0].cpu()
    euler = loop.controller.fbk.root_euler[0].cpu()
    z = float(pos[2])
    summary = {
        "ticks": n_ticks,
        "sim_seconds": n_ticks * C.MPC_DT,
        "wall_seconds": round(wall, 3),
        "realtime_factor": round(n_ticks * C.MPC_DT / wall, 2),
        "final_height_m": round(z, 4),
        "final_xy": [round(float(v), 3) for v in pos[:2]],
        "upright": bool(abs(float(euler[0])) < 0.3
                        and abs(float(euler[1])) < 0.3),
    }
    if args.bag and records:
        import numpy as np
        stacked = {k: np.stack([r[k] for r in records])
                   for k in records[0]}
        # per-tick host wall time: the per-stage timing channel of the
        # observability plan (SURVEY §5 tracing/profiling)
        stacked["tick_wall_ms"] = np.asarray(tick_wall_ms)
        bag_mod.save_bag(args.bag, stacked,
                         meta={"dt": C.MPC_DT, "args": vars(args)})
        summary["bag"] = args.bag
    if args.profile:
        summary["profile"] = args.profile
    if tuner is not None:
        summary["tuning_updates"] = tuner.updates_applied
    print(json.dumps(summary))
    return 0 if summary["upright"] and z > 0.1 else 2


def _run_hardware(args, params, pattern, dtype, device):
    """Hardware path: native runtime carries the 800 Hz UDP link; Python
    runs the MPC-rate loop (reference thread structure: main.cpp:110-256).
    The controller is a batch of one: the raw sensor dict gains a leading
    axis of 1, the commands lose it."""
    import numpy as np
    import torch

    from legged_mpc_control_tpu_torch import constants as C
    from legged_mpc_control_tpu_torch.control import step as step_mod
    from legged_mpc_control_tpu_torch.interfaces.hardware import (
        HardwareInterface,
        UnitreeHardwareInterface,
    )
    from legged_mpc_control_tpu_torch.mpc import convex_mpc

    if args.wire == "unitree":
        iface = UnitreeHardwareInterface(
            peer=(args.robot_ip, args.robot_port))
    else:
        iface = HardwareInterface(peer=(args.robot_ip, args.robot_port))
    iface.start()
    cs = step_mod.controller_init(params, 1, dtype, device,
                                  body_height=args.height)
    pb = step_mod.broadcast_params(params, 1)
    kp = np.tile(params.kp_foot.cpu().numpy(), 4)
    kd = np.tile(params.kd_foot.cpu().numpy(), 4)
    n_ticks = int(args.seconds / C.MPC_DT)
    # solve-time-compensated pacing on an absolute deadline (the reference
    # subtracts the measured loop time from the period, main.cpp:156-162;
    # an absolute deadline additionally avoids drift accumulation)
    deadline = time.perf_counter()
    try:
        for _ in range(n_ticks):
            deadline += C.MPC_DT
            raw = iface.fbk_update()
            if raw is None:
                time.sleep(C.LOW_LEVEL_DT)
                continue
            raw = {k: torch.as_tensor(np.asarray(v), dtype=dtype,
                                      device=device)[None]
                   for k, v in raw.items()}
            cs = step_mod.feedback_update(cs, raw, pb, C.MPC_DT,
                                          kf_type=args.kf)
            cs = convex_mpc.mpc_tick(cs, pb, pattern, C.MPC_DT,
                                     horizon=args.horizon)
            cs, tau, safe = step_mod.lowlevel_update(
                cs, pb, low_level_type=args.low_level)
            if not bool(safe[0]):
                print("safety stop", file=sys.stderr)
                return 3
            iface.send_cmd(cs.ctrl.joint_ang_tgt[0].cpu().numpy(),
                           cs.ctrl.joint_vel_tgt[0].cpu().numpy(),
                           cs.ctrl.joint_tau_tgt[0].cpu().numpy(), kp, kd)
            remaining = deadline - time.perf_counter()
            if remaining > 0:
                time.sleep(remaining)
        print(json.dumps({"ticks": n_ticks, "stats": iface.stats()}))
        return 0
    finally:
        iface.close()


if __name__ == "__main__":
    sys.exit(main())
