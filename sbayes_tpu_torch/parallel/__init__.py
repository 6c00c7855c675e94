"""The parallel layer of the port: the chain-axis split over devices
(``mesh.py``) and its worker processes (``processes.py``). The CLI's run
pool (``-t``) is in ``cli.py``."""
