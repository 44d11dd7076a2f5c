"""Sharded layouts of the port: the device mesh, the process group and its
collectives (``mesh.py``), the sharded stage functions (``step.py``) and a
multi-process runner for checks and sweeps (``sim.py``)."""
