"""The serving layer's framework-free pieces the port carries so far: load-time
statistics, type constraints, the route cache and the reaper's plan step."""
