"""The plain reference of the benchmark's correctness check: a frozen copy
of the port's plain paths (PyTorch ops only, no kernel, no import of the
port), cut to what the cells' ticks run: the convex tick with the plain
Riccati IPM and the plain substep chain, and the CI tick with the plain
sweeps under kernel K7's line-search rule. It runs in any dtype."""
