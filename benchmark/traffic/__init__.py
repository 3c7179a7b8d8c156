"""Traffic: each mix is ``<mix>.json``, the parameters that the driver
of its ``kind``, ``<kind>.py``, reads; a driver module exposes
``Driver(config, traffic, seed, device)``."""
