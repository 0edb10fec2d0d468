"""Chain model, schedule simulator, DP solver, remat compiler and profiler."""
