"""Meters for the port."""
