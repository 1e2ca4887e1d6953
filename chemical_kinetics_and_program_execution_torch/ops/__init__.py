"""Observables, thermodynamics and the host instruments of the port."""
