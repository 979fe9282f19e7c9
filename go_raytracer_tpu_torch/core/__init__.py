"""Sampling helpers shared by the camera and the integrators."""
