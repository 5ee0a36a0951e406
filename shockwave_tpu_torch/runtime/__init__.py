"""Runtime helpers of the port: seeded fault injection for the simulator,
the planner's degradation ladder and the RPC call sites."""
