"""Workload configurations of the port (the event workload only; the LM
configurations are not ported yet)."""
