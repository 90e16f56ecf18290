"""The reservoir simulator."""
