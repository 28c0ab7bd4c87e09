"""Geometry, box math and the checkpoint bridge of the port."""
