"""Measurement tools of the port: synthetic batches and the step profiler."""
