"""ODE solvers of the port: the host-stepped DOP853 (kernel K6)."""
