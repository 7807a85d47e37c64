"""Binary wire and its HTTP client — the port of ``sparktorch_tpu/net``."""
