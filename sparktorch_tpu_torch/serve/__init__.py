"""The hogwild parameter server — the port of ``sparktorch_tpu/serve/param_server.py``."""
