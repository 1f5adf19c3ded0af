import sys

from legged_mpc_control_tpu_torch.main import main

if __name__ == "__main__":
    sys.exit(main())
