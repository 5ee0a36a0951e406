"""Runtime helpers of the port: the solver-fault injection the planner's
degradation ladder consumes."""
