"""Serving: the hogwild parameter server (``param_server.py``) and the online tier (``infer.py``, ``router.py``) — the ports of ``sparktorch_tpu/serve/``."""
