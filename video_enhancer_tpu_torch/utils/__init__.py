"""Metrics, errors, auth, security, perf, memory and logging of the port."""
