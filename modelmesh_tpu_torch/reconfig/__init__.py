"""Zero-downtime reconfiguration: the rolling-upgrade planner
(``rolling.py``; the drain controller is not ported yet)."""
