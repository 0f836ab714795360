"""Zero-downtime reconfiguration: the rolling-upgrade planner
(``rolling.py``) and the instance drain controller (``drain.py``)."""
