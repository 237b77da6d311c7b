"""Helpers shared by the port's subsystems."""
