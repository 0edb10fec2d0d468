"""The host tier: the three-tier solver, the pinned host pool and the eager
op walker that runs offload schedules."""
