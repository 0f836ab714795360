"""The serving layer: the instance (``instance.py``) with its cache
entries, load pipeline, batching, admission, rate tracking and errors,
and the framework-free pieces around it (load-time statistics, type
constraints, the route cache and the reaper's plan step)."""
