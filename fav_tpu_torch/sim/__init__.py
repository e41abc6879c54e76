"""Scripted camera streams for the analyzer's checks."""
